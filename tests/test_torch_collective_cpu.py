"""The port's CpuGroup (ray_tpu_torch/collective/backends/cpu_group.py,
the host data plane over the runtime's RPC) against the JAX package's:
three member actors of each runtime run the same verbs and modes — the
hub, ring and tree planes, int8 compression, partial K-of-N with and
without a straggler, broadcast, reduce, send/recv, barrier — on the same
seeded inputs. The JAX package's cluster runs in a subprocess (two
runtimes cannot share a process); the port's members feed torch tensors
and get torch tensors back. Integer-valued data must match exactly, fp32
sums at rtol 1e-5 (torch sums the hub's stack in its own order), int8
paths within one quantization step."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ray_tpu_torch
from torch_runtime_util import start_cluster, stop_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 3

CASES = [
    ("allreduce", {}),
    ("allreduce", {"op": "max"}),
    ("allreduce", {"algo": "ring"}),
    ("allreduce", {"algo": "tree"}),
    ("allreduce", {"compression": "int8"}),
    ("allreduce", {"algo": "ring", "compression": "int8"}),
    ("allreduce", {"min_ranks": 3}),
    ("allgather", {}),
    ("allgather", {"algo": "ring"}),
    ("allgather", {"compression": "int8"}),
    ("reducescatter", {}),
    ("reducescatter", {"algo": "ring"}),
    ("reducescatter", {"compression": "int8"}),
    ("broadcast", {"src_rank": 1}),
    ("reduce", {"dst_rank": 0}),
]

# One member of either runtime: ``lib`` is ray_tpu or ray_tpu_torch, and
# ``wrap`` turns a numpy input into what the verb is given.
MEMBER = '''
import time
import numpy as np


def make_member(lib, wrap, unwrap):
    import importlib

    @lib.remote
    class Member:
        def setup(self, world, rank, group):
            self.col = importlib.import_module(lib.__name__ + ".collective")
            self.col.init_collective_group(
                world, rank, backend="cpu", group_name=group, timeout_s=30)
            self.rank, self.group = rank, group
            return rank

        def run(self, cases, ints):
            col = self.col
            out = []
            for i, (verb, kw) in enumerate(cases):
                rng = np.random.default_rng(1000 * i + self.rank)
                x = (rng.integers(-8, 9, size=(12, 5)) if ints
                     else rng.normal(size=(12, 5))).astype(np.float32)
                if ints and "compression" in kw:
                    out.append(None)
                    continue
                res = getattr(col, verb)(wrap(x), group_name=self.group,
                                         **kw)
                if hasattr(res, "skipped"):  # a PartialResult
                    out.append(("partial", res.skipped, res.world,
                                unwrap(res.value)))
                else:
                    out.append(unwrap(res))
            return out

        def partial_late(self, delay):
            col = self.col
            col.barrier(group_name=self.group)
            if self.rank == 2:
                time.sleep(delay)
            x = np.full((6,), float(self.rank + 1), np.float32)
            res = col.allreduce(wrap(x), group_name=self.group, min_ranks=2,
                                grace_s=0.3)
            return res.skipped, unwrap(res.value)

        def barrier(self):
            self.col.barrier(group_name=self.group)

        def p2p(self):
            col = self.col
            if self.rank == 0:
                col.send(wrap(np.arange(7, dtype=np.float32)), 1,
                         group_name=self.group, seq=9)
                return None
            if self.rank == 1:
                return unwrap(col.recv(0, group_name=self.group, seq=9))
            return "idle"

    return Member
'''

REF_SCRIPT = '''
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import ray_tpu
import ray_tpu.collective
{member}
ns = {{}}
Member = make_member(ray_tpu, lambda x: x,
                     lambda r: None if r is None else
                     [np.asarray(v) for v in r] if isinstance(r, list)
                     else np.asarray(r))
cases = json.loads(sys.argv[2])
ray_tpu.init(num_cpus=4)
ms = [Member.remote() for _ in range({world})]
ray_tpu.get([m.setup.remote({world}, i, "ref_cpu") for i, m in
             enumerate(ms)], timeout=60)
out = {{}}
for ints in (False, True):
    out[ints] = ray_tpu.get([m.run.remote(cases, ints) for m in ms],
                            timeout=120)
late = ray_tpu.get([m.partial_late.remote(1.0) for m in ms], timeout=60)
p2p = ray_tpu.get([m.p2p.remote() for m in ms], timeout=60)
ray_tpu.shutdown()
import pickle
with open(sys.argv[1], "wb") as f:
    pickle.dump({{"runs": out, "late": late, "p2p": p2p}}, f)
print("REF_OK")
'''


def _unwrap(r):
    """A port result as numpy, after checking it came back as a torch
    tensor (or a list of them) on the CPU."""
    if r is None:
        return None
    if isinstance(r, list):
        return [_unwrap(v) for v in r]
    assert isinstance(r, torch.Tensor) and r.device.type == "cpu", type(r)
    return r.numpy()


def _close(got, want, tol):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):  # a PartialResult's fields
        assert got[:3] == want[:3]
        return _close(got[3], want[3], tol)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if tol == "exact":
        np.testing.assert_array_equal(got, want)
    elif tol == "codec":
        np.testing.assert_allclose(got, want,
                                   atol=2 * np.abs(want).max() / 127)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import json
    import pickle

    path = tmp_path_factory.mktemp("cpu_ref") / "ref.pkl"
    script = tmp_path_factory.mktemp("cpu_ref_s") / "ref.py"
    script.write_text(REF_SCRIPT.format(member=MEMBER, world=WORLD))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    ref = subprocess.Popen(
        [sys.executable, str(script), str(path), json.dumps(CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    info = start_cluster(num_cpus=4)
    try:
        ns = {}
        exec(textwrap.dedent(MEMBER), ns)
        Member = ns["make_member"](ray_tpu_torch, torch.from_numpy, _unwrap)
        ms = [Member.remote() for _ in range(WORLD)]
        ray_tpu_torch.get([m.setup.remote(WORLD, i, "port_cpu")
                           for i, m in enumerate(ms)], timeout=60)
        port = {ints: ray_tpu_torch.get([m.run.remote(CASES, ints)
                                         for m in ms], timeout=120)
                for ints in (False, True)}
        late = ray_tpu_torch.get([m.partial_late.remote(1.0) for m in ms],
                                 timeout=60)
        p2p = ray_tpu_torch.get([m.p2p.remote() for m in ms], timeout=60)
        ray_tpu_torch.get([m.barrier.remote() for m in ms], timeout=60)
        for m in ms:
            ray_tpu_torch.kill(m)
    finally:
        stop_cluster(info)
        out, _ = ref.communicate(timeout=180)
    assert ref.returncode == 0 and "REF_OK" in out, out
    with open(path, "rb") as f:
        want = pickle.load(f)
    return {"runs": port, "late": late, "p2p": p2p}, want


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{v}-{'-'.join(map(str, kw.values()))}"
                              for v, kw in CASES])
def test_verb_matches_reference_cpu_group(results, i):
    port, ref = results
    verb, kw = CASES[i]
    tol = "codec" if "compression" in kw else (
        "exact" if "op" in kw or verb in ("allgather", "broadcast") else
        "fp32")
    for ints in (False, True):
        for rank in range(WORLD):
            got = port["runs"][ints][rank][i]
            want = ref["runs"][ints][rank][i]
            if verb == "reduce" and rank != 0:
                assert got is None and want is None
                continue
            _close(got, want, "exact" if ints else tol)


def test_partial_straggler_and_p2p_match(results):
    port, ref = results
    for (ps, pv), (rs, rv) in zip(port["late"], ref["late"]):
        assert ps == rs == [2]
        np.testing.assert_array_equal(pv, rv)
    assert port["p2p"][0] is None and port["p2p"][2] == "idle"
    np.testing.assert_array_equal(port["p2p"][1], ref["p2p"][1])
