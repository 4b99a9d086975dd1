"""The port's memory ledger (runtime/memory.py) held to the JAX package's:
the same ``tiny`` fp32 train state and the same paged pool make claims
with the same tags, kinds and byte counts in each package's own ledger;
RAY_TPU_MEM_TELEMETRY=0 gives the no-op registration in both; a sample
never imports torch or creates a CUDA context for itself; and a sample
taken in an actor reaches the head's memory ledger.

The JAX package's reference test of the train state's claims
(tests/test_memory_plane.py::test_train_state_registration) is not leaned
on: each case here builds both ledgers itself.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.llm import paged_kv as tpk
from ray_tpu_torch.models.llama import PRESETS
from ray_tpu_torch.runtime import memory as tmem
from ray_tpu_torch.train import step as tstep
from torch_runtime_util import start_cluster, stop_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ledger(mem) -> dict:
    """tag -> (kind, device-side, bytes) of one package's live claims."""
    with mem._reg_lock:
        regs = dict(mem._registry)
    return {tag: (r.kind, r.device, r.current_bytes())
            for tag, r in regs.items()}


@pytest.fixture(autouse=True)
def clean_ledgers():
    from ray_tpu.runtime import memory as jmem

    jmem.clear_registry()
    tmem.clear_registry()
    yield
    jmem.clear_registry()
    tmem.clear_registry()


def _reference_state():
    import jax

    from ray_tpu.models import llama as jllama
    from ray_tpu.train import step as jstep

    jcfg = jllama.PRESETS["tiny"]
    jopt = jstep.make_optimizer(total_steps=10)
    return jstep.init_train_state(jax.random.key(0), jcfg, jopt)


def test_train_state_claims_match_the_reference():
    """Params: the same tag, kind and bytes. Optimizer: the same tag and
    kind, and the bytes of adam's moments; optax also keeps its step
    counts as 0-d int32 arrays on the device, which the port keeps as
    host ints, so those scalars are the only bytes the port does not
    claim."""
    import jax

    from ray_tpu.runtime import memory as jmem

    jstate = _reference_state()
    want = _ledger(jmem)
    assert set(want) == {"train.state.params", "train.state.optimizer"}
    scalars = sum(x.nbytes for x in jax.tree_util.tree_leaves(
        jstate.opt_state) if x.ndim == 0)
    assert scalars > 0
    state = tstep.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                       device="cpu")
    got = _ledger(tmem)
    assert got["train.state.params"] == want["train.state.params"]
    kind, device, nbytes = want["train.state.optimizer"]
    assert got["train.state.optimizer"] == (kind, device, nbytes - scalars)
    assert set(got) == set(want)
    # The port's own init from a seed claims the same.
    tmem.clear_registry()
    tstep._STATE_REGS.clear()
    own = tstep.init_train_state(PRESETS["tiny"],
                                 tstep.make_optimizer(total_steps=10),
                                 device="cpu")
    assert _ledger(tmem) == got
    # The claimed tensors are tagged: an OOM report names them.
    rep = tmem.oom_report(top_n=5)
    assert {b["kind"] for b in rep["buffers"]} <= {"params", "optimizer"}
    assert rep["buffers"] and rep["live_bytes"] == sum(
        v[2] for v in got.values())
    del state, own


@pytest.mark.parametrize("num_pages,page_size", [(4, 8), (17, 64)])
def test_paged_pool_claim_matches_the_reference(num_pages, page_size):
    from ray_tpu.llm import paged_kv as jpk
    from ray_tpu.models import llama as jllama
    from ray_tpu.runtime import memory as jmem

    jkv = jpk.init_paged_kv(jllama.PRESETS["tiny"], num_pages, page_size)
    kv = tpk.init_paged_kv(PRESETS["tiny"], num_pages, page_size,
                           device="cpu")
    want = _ledger(jmem)
    assert want == {"llm.paged_kv": (
        "kv_cache", True, int(jkv["k"].nbytes + jkv["v"].nbytes))}
    assert _ledger(tmem) == want
    assert tmem.registered_bytes()["kv_cache"] == kv["k"].nbytes + kv[
        "v"].nbytes
    # A re-created pool retires the previous claim.
    tpk.init_paged_kv(dataclasses.replace(PRESETS["tiny"], n_layers=1),
                      num_pages, page_size, device="cpu")
    assert _ledger(tmem)["llm.paged_kv"][2] == want["llm.paged_kv"][2] // 2


def test_telemetry_off_registers_nothing(monkeypatch):
    from ray_tpu.llm import paged_kv as jpk
    from ray_tpu.models import llama as jllama
    from ray_tpu.runtime import memory as jmem

    monkeypatch.setenv("RAY_TPU_MEM_TELEMETRY", "0")
    assert tmem.track("x", kind="params", nbytes=10) is tmem.NOOP_REG
    assert jmem.track("x", kind="params", nbytes=10) is jmem.NOOP_REG
    jpk.init_paged_kv(jllama.PRESETS["tiny"], 4, 8)
    tpk.init_paged_kv(PRESETS["tiny"], 4, 8, device="cpu")
    tstep.init_train_state(PRESETS["tiny"],
                           tstep.make_optimizer(total_steps=10),
                           device="cpu")
    assert _ledger(jmem) == {} and _ledger(tmem) == {}
    assert tmem.sample() is None


def test_sample_without_cuda_imports_no_torch():
    """A head, node or CPU worker samples the ledger alone: the sample
    neither imports torch nor creates a CUDA context."""
    code = (
        "import json, sys\n"
        "from ray_tpu_torch.runtime import memory\n"
        "reg = memory.track('t', kind='kv_cache', nbytes=1234)\n"
        "rec = memory.sample(emit=False)\n"
        "print(json.dumps({'hbm': rec['hbm'],"
        " 'torch': 'torch' in sys.modules}))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, env=env)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not got["torch"]
    assert got["hbm"]["source"] == "registered"
    assert got["hbm"]["used_bytes"] == 1234
    assert got["hbm"]["by_kind"]["kv_cache"] == 1234
    assert tmem._device_stats() is None  # no CUDA context here either


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=2)
    yield info
    stop_cluster(info)


def test_actor_sample_reaches_the_head_ledger(cluster):
    @ray_tpu_torch.remote
    class PoolHolder:
        def __init__(self, num_pages, page_size):
            from ray_tpu_torch.llm.paged_kv import init_paged_kv
            from ray_tpu_torch.models.llama import PRESETS

            self.kv = init_paged_kv(PRESETS["tiny"], num_pages, page_size,
                                    device="cpu")

        def sample(self):
            from ray_tpu_torch.runtime import memory

            rec = memory.sample()
            return rec, self.kv["k"].nbytes + self.kv["v"].nbytes

    holder = PoolHolder.remote(9, 16)
    rec, pool_bytes = ray_tpu_torch.get(holder.sample.remote(), timeout=60)
    assert rec["hbm"]["by_kind"]["kv_cache"] == pool_bytes
    rt = ray_tpu_torch.api._runtime
    deadline = time.monotonic() + 30
    while True:
        row = rt.run(rt.core.head.call("mem_stats"))["nodes"].get(
            rec["node"])
        if row and row["by_kind"].get("kv_cache") == pool_bytes:
            break
        assert time.monotonic() < deadline, f"head ledger row: {row}"
        time.sleep(0.2)
    assert row["used_bytes"] == rec["hbm"]["used_bytes"]
    ray_tpu_torch.kill(holder)


def _feed_mem(rt, node, used, cap, ts, job=None, peak=None, by_kind=None):
    rt.run(rt.core.head.call("add_task_events", events=[{
        "task_id": f"span:mem-{node}-{ts}",
        "name": "mem:sample",
        "state": "SPAN",
        "ts": ts,
        "dur": 0.0,
        "mem_node": node,
        "mem_job": job,
        "mem_used_bytes": used,
        "mem_peak_bytes": peak if peak is not None else used,
        "mem_capacity_bytes": cap,
        "mem_host_rss_bytes": 123456,
        "mem_by_kind": by_kind or {},
    }]))


def test_api_memory_schema_and_cli(cluster, capsys, monkeypatch):
    """Dashboard /api/memory returns schema-complete JSON and
    `ray_tpu_torch.scripts mem` renders the same ledger
    (tests/test_memory_plane.py's case)."""
    import urllib.request

    from ray_tpu_torch import scripts
    from ray_tpu_torch.dashboard import start_dashboard

    rt = ray_tpu_torch.api._runtime
    _feed_mem(rt, "nodeD:1", 3 << 30, 16 << 30, time.time(),
              job="cli_job", by_kind={"params": 2 << 30})
    dash = start_dashboard()
    try:
        with urllib.request.urlopen(dash.url + "/api/memory",
                                    timeout=10) as r:
            body = json.loads(r.read())
    finally:
        dash.stop()
    assert "nodes" in body and "jobs" in body
    required = {
        "used_bytes", "peak_bytes", "capacity_bytes", "headroom_bytes",
        "host_rss_bytes", "by_kind", "samples", "alert", "first_ts",
        "last_ts",
    }
    for name, node in body["nodes"].items():
        assert required <= set(node), (name, sorted(node))
    assert "nodeD:1" in body["nodes"]
    assert "cli_job" in body["jobs"]

    monkeypatch.setattr(scripts, "_connect", lambda *a, **k: None)
    rc = scripts.main(["mem"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "nodeD:1" in out and "used=" in out and "headroom=" in out
    assert "by kind:" in out and "params=" in out
    assert "job cli_job:" in out
    rc = scripts.main(["mem", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and "nodeD:1" in out["nodes"]
