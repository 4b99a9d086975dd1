"""NcclDistGroup + bootstrap_distributed (ray_tpu_torch/collective/
backends/nccl_group.py) over gloo across real processes, against the JAX
package's XlaDistGroup: each rank process joins one jax.distributed world
and one port group (a TCPStore and a gloo process group of the group's
own), runs every verb and mode of tests/test_multihost.py and
tests/test_partial_collective.py through both on the same seeded numpy
inputs, and compares. fp32 sums at rtol 1e-5 (reassociation), integer
data exactly, int8 paths within one quantization step of the reduced
value. Then the fault-tolerance cases of tests/test_collective_ft.py as
this backend has them (deadline naming the op, poison abort before the
deadline, rendezvous timeout), and the group through the port's runtime:
init_collective_group(backend="nccl", dist_backend="gloo") rendezvousing
through a real head's KV."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch

TIMEOUT = 120
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(scripts, tmp_path, timeout=TIMEOUT):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    procs = []
    for i, text in enumerate(scripts):
        path = tmp_path / f"rank{i}.py"
        path.write_text(textwrap.dedent(text))
        procs.append(subprocess.Popen(
            [sys.executable, str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank{i} rc={p.returncode}:\n{out}"
    return outs


PARITY_SCRIPT = """
    import datetime, os, time
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address="127.0.0.1:{jport}",
                               num_processes={world}, process_id={rank})
    import numpy as np
    import jax.numpy as jnp
    import torch
    import torch.distributed as dist
    from ray_tpu.collective.backends.xla_group import XlaDistGroup
    from ray_tpu.collective.types import ReduceOp as RefOp
    from ray_tpu_torch.collective.backends.nccl_group import NcclDistGroup
    from ray_tpu_torch.collective.types import PartialResult, ReduceOp

    rank, world = {rank}, {world}
    store = dist.TCPStore("127.0.0.1", {tport}, world, rank == 0,
                          datetime.timedelta(seconds=60))
    ref = XlaDistGroup(world, rank, timeout_s=60)
    port = NcclDistGroup(world, rank, timeout_s=60, name="dist_t",
                         store=store, dist_backend="gloo")
    rng = np.random.default_rng(100 + rank)

    def check(name, want, got, tol):
        if isinstance(want, (list, tuple)) or hasattr(want, "skipped"):
            assert got.skipped == want.skipped, (name, got, want)
            assert got.contributed == want.contributed, name
            want, got = want.value, got.value
        assert isinstance(got, torch.Tensor), name
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if tol == "exact":
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif tol == "codec":
            np.testing.assert_allclose(
                g, w, atol=2 * np.abs(w).max() / 127, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)

    def both(verb, x, tol, **kw):
        rkw = dict(kw)
        if "op" in kw:
            rkw["op"] = RefOp(kw["op"].value)
        want = getattr(ref, verb)(jnp.asarray(x), **rkw)
        got = getattr(port, verb)(torch.from_numpy(np.asarray(x)), **kw)
        check(f"{{verb}} {{kw}}", want, got, tol)
        return got

    x = rng.normal(size=(33, 5)).astype(np.float32)
    xi = rng.integers(-8, 9, size=(12, 3)).astype(np.float32)
    for data, tol in ((x, "fp32"), (xi, "exact")):
        both("allreduce", data, tol)
        both("allreduce", data, "exact", op=ReduceOp.MAX)
        both("allreduce", data, "exact", op=ReduceOp.MIN)
        both("allreduce", data, tol, algo="ring")
        both("allreduce", data, tol, algo="tree")
        both("allgather", data, "exact")
        both("broadcast", data, "exact", root=world - 1)
    both("reducescatter", xi, "exact")
    both("reducescatter", xi, "exact", algo="tree")
    both("reducescatter", xi, "exact", op=ReduceOp.MAX)
    assert port._last_wire_bytes == ref._last_wire_bytes
    big = rng.normal(size=(128, 128)).astype(np.float32)
    both("allreduce", big, "codec", compression="int8")
    both("reducescatter", rng.normal(size=(8 * world, 3)).astype(np.float32),
         "codec", compression="int8")
    both("allgather", rng.normal(size=(300,)).astype(np.float32), "codec",
         compression="int8")
    assert port.last_route == "gloo"
    # Partial: every rank in time → contributed all; the last rank late
    # by more than the grace → skipped, sum rescaled world/(world-1).
    both("allreduce", x, "fp32", min_ranks=1, grace_s=30.0)
    for verb, kw, data in (
        ("allreduce", {{}}, x),
        ("reducescatter", {{}}, xi),
        ("allreduce", {{"compression": "int8"}}, big),
    ):
        ref.barrier()
        if rank == world - 1:
            time.sleep(0.8)
        want = getattr(ref, verb)(jnp.asarray(data), min_ranks=1,
                                  grace_s=0.3, **kw)
        port.barrier()
        if rank == world - 1:
            time.sleep(0.8)
        got = getattr(port, verb)(torch.from_numpy(data), min_ranks=1,
                                  grace_s=0.3, **kw)
        assert got.skipped == want.skipped == [world - 1], (verb, got)
        check(f"partial {{verb}} {{kw}}", want, got,
              "codec" if kw else ("exact" if data is xi else "fp32"))
    # Async verbs: the same values as the sync ones, issued in order.
    works = [port.allreduce_async(torch.from_numpy(x)),
             port.allgather_async(torch.from_numpy(xi)),
             port.reducescatter_async(torch.from_numpy(xi))]
    check("async allreduce", ref.allreduce(jnp.asarray(x)),
          works[0].wait(), "fp32")
    check("async allgather", ref.allgather(jnp.asarray(xi)),
          works[1].wait(), "exact")
    check("async reducescatter", ref.reducescatter(jnp.asarray(xi)),
          works[2].wait(), "exact")
    port.barrier()
    print(f"RANK{{rank}}_OK")
"""


@pytest.mark.parametrize("world", [2, 3])
def test_dist_group_matches_xla_dist(tmp_path, world):
    jport, tport = _free_port(), _free_port()
    outs = _run_ranks(
        [PARITY_SCRIPT.format(rank=r, world=world, jport=jport, tport=tport)
         for r in range(world)], tmp_path)
    for r in range(world):
        assert f"RANK{r}_OK" in outs[r]


FT_SCRIPT = """
    import asyncio, datetime, threading, time
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.collective.backends.nccl_group import NcclDistGroup
    from ray_tpu_torch.collective.types import (
        CollectiveMemberDiedError, CollectiveTimeoutError)

    rank = {rank}
    store = dist.TCPStore("127.0.0.1", {tport}, 2, rank == 0,
                          datetime.timedelta(seconds=30))
    g, g2, g3 = (NcclDistGroup(2, rank, timeout_s=30, name=n, store=store,
                               dist_backend="gloo")
                 for n in ("ft", "ft2", "p2p"))
    if rank == 0:
        # Rank 1 never joins this op: the deadline names the op.
        t0 = time.monotonic()
        try:
            g.allreduce(torch.ones(4), timeout_s=1.0)
            raise AssertionError("no timeout")
        except CollectiveTimeoutError as e:
            assert e.op == "allreduce" and e.timeout_s == 1.0, e
        assert time.monotonic() - t0 < 5
        # A death fan-out aborts a wedged wait before its deadline.
        threading.Timer(0.5, g2._on_member_dead, args=([1],)).start()
        t0 = time.monotonic()
        try:
            g2.allreduce(torch.ones(4))
            raise AssertionError("no abort")
        except CollectiveMemberDiedError as e:
            assert e.dead_ranks == [1], e
        assert time.monotonic() - t0 < 5
        # ... and the poisoned group refuses every later op at once.
        try:
            g2.allgather(torch.ones(1))
            raise AssertionError("not poisoned")
        except CollectiveMemberDiedError:
            pass
    # Point to point: a send posted before the recv, header in the store.
    if rank == 0:
        asyncio.run(g3.send(torch.arange(6.0).reshape(2, 3), 1, seq=5))
    else:
        got = asyncio.run(g3.recv(0, seq=5))
        assert torch.equal(got, torch.arange(6.0).reshape(2, 3)), got
        assert g3.last_route == "gloo"
        try:
            asyncio.run(g3.recv(0, seq=6, timeout_s=1.0))
            raise AssertionError("recv without a send")
        except CollectiveTimeoutError as e:
            assert e.missing_ranks == [0]
    g3.barrier()
    print(f"FT{{rank}}_OK")
"""


def test_dist_group_deadline_poison_and_p2p(tmp_path):
    tport = _free_port()
    outs = _run_ranks([FT_SCRIPT.format(rank=r, tport=tport)
                       for r in (0, 1)], tmp_path)
    assert "FT0_OK" in outs[0] and "FT1_OK" in outs[1]


BOOTSTRAP_SCRIPT = """
    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch import collective as col

    rank = {rank}
    ray_tpu_torch.init(address="{addr}", num_cpus=1)
    col.init_collective_group(2, rank, backend="nccl", group_name="{group}",
                              dist_backend="gloo")
    out = col.allreduce(torch.full((4,), float(rank + 1)),
                        group_name="{group}")
    np.testing.assert_allclose(out.numpy(), 3.0)
    ag = col.allgather(torch.full((1,), float(rank)), group_name="{group}")
    np.testing.assert_allclose(ag.numpy(), [0.0, 1.0])
    col.barrier(group_name="{group}")
    if rank == 0:
        col.send(torch.full((3,), 7.0), 1, group_name="{group}", seq=3)
    else:
        got = col.recv(0, group_name="{group}", seq=3)
        np.testing.assert_allclose(got.numpy(), 7.0)
    col.destroy_collective_group("{group}")
    ray_tpu_torch.shutdown()
    print(f"BOOT{{rank}}_OK")
"""


def test_bootstrap_distributed_via_head(tmp_path):
    """Two driver processes rendezvous through the port's head KV (the
    NCCLUniqueID-store replacement: a TCPStore address) and run verbs
    over gloo; a rank whose coordinator never publishes times out."""
    info = ray_tpu_torch.init(num_cpus=2)
    try:
        outs = _run_ranks(
            [BOOTSTRAP_SCRIPT.format(rank=r, addr=info["address"],
                                     group="boot_t") for r in (0, 1)],
            tmp_path)
        assert "BOOT0_OK" in outs[0] and "BOOT1_OK" in outs[1]
        from ray_tpu_torch import collective as col
        from ray_tpu_torch.collective.types import CollectiveTimeoutError

        with pytest.raises(CollectiveTimeoutError) as ei:
            col.init_collective_group(2, 1, backend="nccl",
                                      group_name="never_t", timeout_s=1.0,
                                      dist_backend="gloo")
        assert ei.value.missing_ranks == [0]
        assert not col.is_group_initialized("never_t")
    finally:
        ray_tpu_torch.shutdown()
