"""The port's sweep engine (ray_tpu_torch/tune/sweep.py) on its runtime:
tests/test_tune_sweep.py's admission, failure-classification and
search-protocol cases, gangs packed on 2 fake GPUs, the sweep table
surviving a head SIGKILL, and a PBT exploit that forks the winner's
checkpoint into the loser's run without new bytes.

The fork case differs from the JAX package's
``test_pbt_fork_moves_zero_bytes``, which races the clock (steps of 0.1 s
against polls of 0.15 s: the exploit needs both trials still running and
the winner's manifest complete, or the fork is skipped). Here two trials
run at once on the 2 fake GPUs, each saves only at the checkpointed step,
waits for the save to commit and for every trial of the sweep to have
committed that step before it reports the step, and then waits for the
fork to be journaled before it steps on: no exploit can find the
winner's manifest incomplete or the winner gone, and the ledger holds
still until the fork. The relaunched loser steps only once the winner
has ended, so no second exploit can pair them. The losses (w decays
alike in every trial) keep the winner ahead of the loser at every step.
Every wait has a deadline.

Train loops are made by factories (closures pickle by value; a test
module's top-level function pickles by reference and the worker cannot
import it), with every helper they call defined inside.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import config as _config
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ admission
def _status(nodes, draining=None, slices=None):
    return {"nodes": nodes, "draining": draining or {},
            "slices": slices or {}}


def _nodes(kind):
    return {
        "n0": {"resources": {kind: 4.0}, "available": {kind: 2.0}},
        "n1": {"resources": {kind: 4.0}, "available": {kind: 4.0}},
        "n2": {"resources": {kind: 4.0}, "available": {kind: 4.0}},
    }


_VIEWS = [
    {},
    {"draining": {"n1": {"reason": "preempt"}}},
    {"slices": {"s0": {"state": "degraded", "nodes": ["n1", "n2"]}}},
    {"draining": {"n1": {"reason": "preempt"}},
     "slices": {"s0": {"state": "healthy", "nodes": ["n1", "n2"]}}},
]


def test_admission_counts_only_healthy_gpus():
    """The JAX package's case with GPUs for chips: a draining node's GPUs
    and every node of a sick slice are condemned capacity."""
    from ray_tpu_torch.train.admission import admit_gang, cluster_chips

    nodes = _nodes("GPU")
    assert cluster_chips(_status(nodes)) == (10.0, 12.0)
    assert cluster_chips(_status(nodes, **_VIEWS[1])) == (6.0, 8.0)
    assert cluster_chips(_status(nodes, **_VIEWS[2])) == (2.0, 4.0)
    assert cluster_chips(_status(nodes, **_VIEWS[3])) == (2.0, 4.0)
    ticket = admit_gang(3, 4.0, status=_status(nodes))
    assert not ticket and "12" in ticket.reason
    ticket = admit_gang(2, 2.0, status=_status(nodes))
    assert ticket and ticket.required_chips == 4.0


@pytest.mark.parametrize("view", range(len(_VIEWS)))
def test_admission_equals_the_reference(view):
    """The same cluster view, GPUs in the port where the JAX package has
    TPU chips, gives the same (free, total) and the same tickets."""
    from ray_tpu.train import admission as jadm

    from ray_tpu_torch.train import admission as tadm

    got_status = _status(_nodes("GPU"), **_VIEWS[view])
    want_status = _status(_nodes("TPU"), **_VIEWS[view])
    assert tadm.cluster_chips(got_status) == jadm.cluster_chips(want_status)
    for n, per in ((1, 1.0), (2, 2.0), (3, 4.0), (4, 0.5)):
        got = tadm.admit_gang(n, per, status=got_status)
        want = jadm.admit_gang(n, per, status=want_status)
        assert (bool(got), got.reason, got.required_chips, got.free_chips,
                got.total_chips) == (bool(want), want.reason,
                                     want.required_chips, want.free_chips,
                                     want.total_chips)


def test_admission_cpu_fallback():
    from ray_tpu_torch.train.admission import cluster_chips

    nodes = {"n0": {"resources": {"CPU": 8.0}, "available": {"CPU": 3.0}}}
    assert cluster_chips(_status(nodes)) == (3.0, 8.0)


def test_admission_memory_pricing():
    """A config that cannot fit one card's memory is rejected outright,
    whatever is free; sharded over fsdp=8 it fits."""
    import dataclasses as dc

    from ray_tpu_torch.models.llama import PRESETS
    from ray_tpu_torch.train.admission import admit_gang

    cfg = dc.replace(PRESETS["llama3_8b"], n_layers=6, vocab_size=8192,
                     attn_impl="flash", remat="full")
    nodes = {"n0": {"resources": {"GPU": 8.0}, "available": {"GPU": 8.0}}}
    kw = {"cfg": cfg, "batch": 1, "seq": 4096, "mu_dtype": "bfloat16",
          "hbm_gb": 16.0}
    big = admit_gang(1, 1.0, plan_kwargs=kw, status=_status(nodes))
    assert not big and not big.plan.fits and "memory plan" in big.reason
    small = admit_gang(1, 1.0, plan_kwargs={**kw, "fsdp": 8},
                       status=_status(nodes))
    assert small and small.plan.fits


# ------------------------------------------------ failure classification
def test_classify_failure_typed():
    from ray_tpu_torch import exceptions as E
    from ray_tpu_torch.tune.tuner import (
        INFRA,
        PREEMPTED,
        TRIAL,
        classify_failure,
    )

    assert classify_failure(E.PreemptedError("drain")) == PREEMPTED
    assert classify_failure(E.WorkerDiedError("gone")) == INFRA
    assert classify_failure(E.ActorDiedError("gone")) == INFRA
    assert classify_failure(ValueError("user bug")) == TRIAL
    wrapped = E.RayTaskError("task failed")
    wrapped.cause = E.PreemptedError("node reclaimed")
    assert classify_failure(wrapped) == PREEMPTED
    assert classify_failure("PreemptedError: slice reclaimed") == PREEMPTED
    assert classify_failure("WorkerDiedError: oom") == INFRA
    assert classify_failure("KeyError: 'lr'") == TRIAL


def test_search_algorithm_protocol():
    from ray_tpu_torch import tune

    space = {"x": tune.uniform(0, 1)}
    algos = [
        tune.BasicVariantGenerator(space, num_samples=2),
        tune.TPESearcher(space, metric="loss", mode="min"),
        tune.OptunaSearch(space, metric="loss"),
        tune.HyperOptSearch(space, metric="loss"),
        tune.BOHBSearch(space, metric="loss"),
        tune.ConcurrencyLimiter(
            tune.BasicVariantGenerator(space, num_samples=2), 1),
        tune.Repeater(tune.BasicVariantGenerator(space, num_samples=2), 2),
    ]
    for algo in algos:
        assert isinstance(algo, tune.SearchAlgorithm), type(algo)
        cfg = algo.suggest("t0")
        assert cfg is None or cfg is tune.search.DEFER or "x" in cfg
        algo.on_trial_complete("t0", {"loss": 0.5})


def test_sweep_config_leases_gpus():
    """A trial gang's bundle: gpus_per_worker of the GPU resource (and
    none at 0), resources_per_worker merged in."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.sweep import _SweepTrial

    def trainer(**kw):
        sweep = tune.Sweep(lambda c: None, {}, sweep_id="lease",
                           config=tune.SweepConfig(**kw))
        return sweep._make_trainer(_SweepTrial("t0000", {"lr": 1.0},
                                               "lease/t0000"))

    t = trainer(gpus_per_worker=0.5, workers_per_trial=2,
                resources_per_worker={"SLICE": 1.0})
    assert type(t).__name__ == "TorchTrainer"
    assert t.scaling.num_workers == 2
    assert t.scaling.bundle() == {"CPU": 1.0, "SLICE": 1.0, "GPU": 0.5}
    assert t.run_config.name == "lease/t0000"
    assert (t.run_config.sweep_id, t.run_config.trial_id) == ("lease",
                                                             "t0000")
    assert t.run_config.resume_from_checkpoint == "auto"
    assert trainer().scaling.bundle() == {"CPU": 1.0}


# ------------------------------------------------------- live sweep runs
@pytest.fixture
def gpu_cluster():
    """One node reporting 2 fake GPUs (CPU-backed workers)."""
    os.environ["RAY_TPU_FAKE_CHIPS"] = "2"
    try:
        info = start_cluster(num_cpus=8)
    finally:
        os.environ.pop("RAY_TPU_FAKE_CHIPS", None)
    yield info
    stop_cluster(info)
    _config._overrides.pop("FAKE_CHIPS", None)


def _report_loop_factory():
    """Reports loss = lr / step; the last report also carries the loop's
    start and end (wall clock): the span the gang held its GPU in."""

    def loop(config):
        import time as _t

        from ray_tpu_torch import train

        start = _t.time()
        for step in range(config["steps"]):
            _t.sleep(config.get("step_s", 0.05))
            span = ({"start": start, "end": _t.time()}
                    if step == config["steps"] - 1 else {})
            train.report({"loss": float(config["lr"]) / (step + 1), **span})

    return loop


def test_sweep_gangs_pack_concurrently(gpu_cluster, tmp_path):
    """4 one-GPU gangs on 2 GPUs: trials pack two at a time, every trial
    terminates, and the sweep table is journaled on the head."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.util import state

    assert ray_tpu_torch.cluster_resources().get("GPU") == 2.0
    sweep = tune.Sweep(
        _report_loop_factory(),
        {"lr": tune.grid_search([0.1, 0.9, 0.2, 0.8]), "steps": 6,
         "step_s": 0.08},
        sweep_id="pack",
        storage_path=str(tmp_path),
        config=tune.SweepConfig(num_samples=1, workers_per_trial=1,
                                gpus_per_worker=1.0, poll_s=0.1),
    )
    res = sweep.run()
    assert len(res.trials) == 4
    assert all(t.state == "TERMINATED" for t in res.trials), [
        (t.trial_id, t.state, t.error) for t in res.trials]
    spans = sorted((t.started_ts, t.ended_ts) for t in sweep.trials
                   if t.started_ts and t.ended_ts)
    overlaps = sum(1 for (s0, e0), (s1, _) in zip(spans, spans[1:])
                   if s1 < e0)
    assert overlaps >= 1, spans
    # At most two gangs at once: no three loops share an instant.
    loops = [(t.result.metrics["start"], t.result.metrics["end"])
             for t in sweep.trials]
    for s, _ in loops:
        assert sum(1 for a, b in loops if a <= s < b) <= 2, loops
    frees = [f for _ts, f, total in sweep.utilization if total > 0]
    assert frees and min(frees) == 0.0 and all(f >= 0 for f in frees)
    assert all(total == 2.0 for _ts, _f, total in sweep.utilization)
    assert res.best().config["lr"] in (0.1, 0.2)
    ss = state.sweep_stats(sweep_id="pack")["sweeps"]["pack"]
    assert ss["state"] == "FINISHED"
    assert len(ss["trials"]) == 4
    for rec in ss["trials"].values():
        assert rec["state"] == "TERMINATED"
        assert rec["ledger"]["steps"] == 6
        assert rec["ledger"]["loss"] is not None
    assert res.stats["chip_idle_fraction"] is not None


def _fork_loop_factory():
    """A trial that steps w <- 0.99 w from w = lr, reports loss = mean(w)
    per step, saves into the shard store only at config["save_at"],
    reports that step once the save has committed and every trial of the
    sweep has committed it, and then waits until the sweep's fork is
    journaled before it steps on. A relaunch restores the forked
    checkpoint and steps once the trial it forked from has ended.
    Each step's (trial, step, loss, lr, restored uri) goes to a JSON
    lines file per trial under config["out"]."""

    def loop(config):
        import json as _json
        import os as _os
        import time as _t

        import numpy as np

        from ray_tpu_torch import checkpoint as ckpt
        from ray_tpu_torch import train
        from ray_tpu_torch.util import state as _state

        def wait_for(pred, what, deadline_s=config["deadline_s"]):
            end = _t.monotonic() + deadline_s
            while not pred():
                if _t.monotonic() > end:
                    raise TimeoutError(f"waited {deadline_s} s for {what}")
                _t.sleep(0.05)

        def sweep_row():
            return _state.sweep_stats(sweep_id=ctx.sweep_id)["sweeps"][
                ctx.sweep_id]

        def all_committed(step):
            jobs = [t["job"] for t in sweep_row()["trials"].values()]
            return all(ckpt.latest_step(j) == step for j in jobs)

        ctx = train.get_context()
        st = {"w": np.full(4, config["lr"], np.float32)}
        uri = train.get_checkpoint()
        start = 0
        if uri is not None:
            st = ckpt.restore_uri(uri, target=st)
            start = ckpt.parse_uri(uri)[1]
            # A relaunch after an exploit starts once the trial it forked
            # from has ended, so no later exploit can pair the two again.
            trials = sweep_row()["trials"]
            source = trials[ctx.trial_id]["forked_from"]
            wait_for(lambda: sweep_row()["trials"][source]["state"]
                     == "TERMINATED" or sweep_row()["trials"][source].get(
                         "forked_from") == ctx.trial_id,
                     "the fork's source to end")
        cp = ckpt.AsyncCheckpointer()
        path = _os.path.join(config["out"], f"{ctx.trial_id}.jsonl")
        for step in range(start, config["steps"]):
            _t.sleep(config["step_s"])
            loss = float(st["w"].mean())
            st = {"w": st["w"] * np.float32(0.99)}
            if step + 1 == config["save_at"]:
                cp.save(step + 1, st)
                cp.wait()
                wait_for(lambda: all_committed(config["save_at"]),
                         "every trial's checkpoint")
            with open(path, "a") as f:
                f.write(_json.dumps({"step": step, "loss": loss,
                                     "lr": config["lr"],
                                     "restored": uri}) + "\n")
            train.report({"loss": loss})
            if step + 1 == config["save_at"]:
                wait_for(lambda: sweep_row().get("forks", 0) >= 1,
                         "the fork")

    return loop


def _read_steps(out, trial_id):
    with open(os.path.join(out, f"{trial_id}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("lrs", [(0.1, 0.9), (0.9, 0.1)],
                         ids=["winner-first", "loser-first"])
def test_pbt_fork_moves_zero_bytes(gpu_cluster, tmp_path, lrs):
    """A PBT exploit forks the winner's manifest into the loser's run:
    no new chunks, the loser relaunched with the mutation restores the
    winner's state (its first loss is the winner's at that step) and
    finishes; the journal carries the lineage."""
    from ray_tpu_torch import checkpoint as ckpt
    from ray_tpu_torch import tune
    from ray_tpu_torch.util import state

    out = tmp_path / "steps"
    out.mkdir()
    sweep_id = "pbtfork-" + ("a" if lrs[0] < lrs[1] else "b")
    save_at, steps = 4, 8
    sweep = tune.Sweep(
        _fork_loop_factory(),
        {"lr": tune.grid_search(list(lrs)), "steps": steps,
         "save_at": save_at, "step_s": 0.05, "out": str(out),
         "deadline_s": 60.0},
        sweep_id=sweep_id,
        storage_path=str(tmp_path / "results"),
        config=tune.SweepConfig(
            num_samples=1, workers_per_trial=1, gpus_per_worker=1.0,
            pbt=tune.LedgerPBT(
                metric="loss", mode="min", perturbation_interval=save_at,
                hyperparam_mutations={"lr": [0.05]},
                quantile_fraction=0.5, seed=7),
            poll_s=0.1),
    )
    res = sweep.run()
    assert all(t.state == "TERMINATED" for t in res.trials), [
        (t.trial_id, t.state, t.error) for t in res.trials]
    assert res.stats["forks"] == 1
    forked = [t for t in res.trials if t.forked_from]
    assert len(forked) == 1
    loser = forked[0]
    winner = next(t for t in res.trials if t.trial_id == loser.forked_from)
    assert winner.config["lr"] == 0.1 and loser.config["lr"] == 0.05
    rec = state.sweep_stats()["sweeps"][sweep_id]["trials"][loser.trial_id]
    assert rec["forked_from"] == winner.trial_id
    assert rec["fork_step"] == save_at
    share = ckpt.fork_shares_chunks(f"{sweep_id}/{winner.trial_id}",
                                    f"{sweep_id}/{loser.trial_id}", save_at)
    assert share["new_chunks"] == 0 and share["dedup_ratio"] == 1.0
    assert share["dst_chunks"] > 0
    # The relaunch restored the winner's state at the fork step.
    won = {r["step"]: r["loss"] for r in _read_steps(out, winner.trial_id)}
    lost = _read_steps(out, loser.trial_id)
    resumed = [r for r in lost if r["restored"]]
    assert resumed and resumed[0]["step"] == save_at
    assert resumed[0]["restored"] == (
        f"ckpt://{sweep_id}/{loser.trial_id}/{save_at}")
    assert resumed[0]["lr"] == 0.05
    assert [r["step"] for r in resumed] == list(range(save_at, steps))
    assert resumed[0]["loss"] == won[save_at]
    assert sorted(won) == list(range(steps))


# ------------------------------------------------- head-SIGKILL survival
_SIGKILL_CHILD = textwrap.dedent(
    """
    import asyncio, os, signal, sys
    from ray_tpu_torch._private import rpc

    path = sys.argv[1]

    async def go():
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService(journal_path=path)
        addr = await head.start()
        conn = await rpc.connect(addr)
        await conn.call(
            "sweep_put", sweep_id="s1",
            fields={"state": "RUNNING", "num_samples": 2, "forks": 1},
        )
        await conn.call(
            "sweep_trial", sweep_id="s1", trial_id="t0000",
            fields={"state": "RUNNING", "job": "s1/t0000",
                    "config": {"lr": 0.1}},
        )
        await conn.call(
            "sweep_trial", sweep_id="s1", trial_id="t0001",
            fields={"state": "TERMINATED", "job": "s1/t0001",
                    "forked_from": "t0000"},
        )
        # Die WITHOUT stopping: every surviving byte is journal replay.
        os.kill(os.getpid(), signal.SIGKILL)

    asyncio.run(go())
    """
)


def test_sweep_table_survives_head_sigkill(tmp_path):
    """sweep_put / sweep_trial journal through the head's WAL: a restart
    after SIGKILL replays the sweeps table, through the snapshot path
    too."""
    import asyncio

    from ray_tpu_torch._private import rpc

    path = str(tmp_path / "head.journal")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", _SIGKILL_CHILD, path],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout,
                                                proc.stderr)

    async def restart(compact: bool):
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService(journal_path=path)
        addr = await head.start()
        conn = await rpc.connect(addr)
        try:
            reply = await conn.call("sweep_stats")
            if compact:
                head.journal.compact(head._snapshot())
            return reply
        finally:
            await conn.close()
            await head.stop()

    for compact in (True, False):
        reply = asyncio.run(restart(compact))
        rec = reply["sweeps"]["s1"]
        assert rec["state"] == "RUNNING"
        assert rec["forks"] == 1
        assert rec["trials"]["t0000"]["state"] == "RUNNING"
        assert rec["trials"]["t0000"]["config"] == {"lr": 0.1}
        assert rec["trials"]["t0001"]["forked_from"] == "t0000"


# ------------------------------------------- preemption-tolerant sweeps
def _add_node(tmp_path, name, resources):
    from ray_tpu_torch.runtime.node import NodeManager

    rt = ray_tpu_torch.api._runtime

    async def launch():
        node = NodeManager(rt.core.head_addr, str(tmp_path / f"{name}_store"),
                           resources=resources)
        await node.start()
        return node

    return rt.run(launch())


def _stop_node(node):
    rt = ray_tpu_torch.api._runtime
    try:
        rt.run(node.stop())
    except Exception:  # noqa: BLE001 - may already be dead
        pass


def _migrate_loop_factory():
    """One step per tick with per-attempt progress files; checkpoints
    every 4 steps and at once on a preemption notice (the emergency
    checkpoint), so a migration re-runs at most one step."""

    def loop(config):
        import json as _json
        import os as _os
        import time as _t

        from ray_tpu_torch import train

        ctx = train.get_context()
        start = 0
        ck = train.get_checkpoint()
        if ck:
            with open(_os.path.join(ck, "state.json")) as f:
                start = _json.load(f)["step"] + 1
        scratch = config["scratch"]
        with open(_os.path.join(scratch, f"start_attempt{ctx.attempt}"),
                  "w") as f:
            f.write(str(start))
        if ctx.attempt == 0 and ctx.rank == 0:
            from ray_tpu_torch import api as _api

            with open(config["marker"], "w") as f:
                f.write(_api._runtime.core.node_addr or "")
        for step in range(start, config["steps"]):
            _t.sleep(0.15)
            with open(_os.path.join(scratch, f"prog_attempt{ctx.attempt}"),
                      "w") as f:
                f.write(str(step))
            ckdir = None
            if step % 4 == 0 or train.preemption_notice() is not None:
                ckdir = _os.path.join(scratch, f"ck_{step}")
                _os.makedirs(ckdir, exist_ok=True)
                with open(_os.path.join(ckdir, "state.json"), "w") as f:
                    _json.dump({"step": step}, f)
            train.report({"loss": 1.0 / (step + 1)}, checkpoint=ckdir)

    return loop


@pytest.mark.chaos
def test_sweep_trial_migrates_on_preemption(tmp_path):
    """Drain the node under a running gang mid-sweep: the gang takes an
    emergency checkpoint inside the notice window, unwinds typed, and the
    sweep re-admits it elsewhere, re-running at most one step; the sweep
    journals the migration (preemptions counter, attempts)."""
    import threading
    import time

    info = start_cluster(num_cpus=2,
                         _system_config={"HEALTH_TIMEOUT_S": 4.0})
    nodes = [_add_node(tmp_path, f"slice{i}", {"CPU": 2.0, "SLICE": 1.0})
             for i in range(2)]
    try:
        from ray_tpu_torch import tune
        from ray_tpu_torch.util import state

        marker = str(tmp_path / "victim_addr")
        scratch = str(tmp_path / "scratch")
        os.makedirs(scratch, exist_ok=True)
        sweep = tune.Sweep(
            _migrate_loop_factory(),
            {"steps": 14, "scratch": scratch, "marker": marker},
            sweep_id="mig", storage_path=str(tmp_path / "results"),
            config=tune.SweepConfig(
                num_samples=1, workers_per_trial=1,
                resources_per_worker={"SLICE": 1.0}, poll_s=0.1,
                max_failures=3),
        )

        def drainer():
            deadline = time.monotonic() + 60
            while (time.monotonic() < deadline
                   and not os.path.exists(marker)):
                time.sleep(0.05)
            with open(marker) as f:
                victim_addr = f.read().strip()
            victim = next(n for n in nodes if n.addr == victim_addr)
            rt = ray_tpu_torch.api._runtime

            async def drain():
                return await rt.core.head.call(
                    "drain_node", node_id=victim.node_id,
                    reason="preemption-notice", deadline_s=5.0)

            rt.run(drain())
            time.sleep(5.0)
            for w in list(victim.workers.values()):
                proc = w.get("proc")
                if proc and proc.poll() is None:
                    proc.kill()
            _stop_node(victim)

        t = threading.Thread(target=drainer, daemon=True)
        t.start()
        res = sweep.run()
        t.join(timeout=30)
        assert not t.is_alive()

        trial = res.trials[0]
        assert trial.state == "TERMINATED", (trial.state, trial.error)
        assert trial.attempts >= 2
        assert res.stats["preemptions"] >= 1
        with open(os.path.join(scratch, "prog_attempt0")) as f:
            last_before_kill = int(f.read())
        with open(os.path.join(scratch, "start_attempt1")) as f:
            resumed_at = int(f.read())
        assert last_before_kill - resumed_at + 1 <= 1, (last_before_kill,
                                                        resumed_at)
        prog = sorted(int(open(os.path.join(scratch, p)).read())
                      for p in os.listdir(scratch)
                      if p.startswith("prog_attempt"))
        assert prog[-1] == 13
        rec = state.sweep_stats()["sweeps"]["mig"]
        assert rec["preemptions"] >= 1
        assert rec["trials"][trial.trial_id]["attempts"] >= 2
    finally:
        for node in nodes:
            _stop_node(node)
        stop_cluster(info)
        _config._overrides.pop("HEALTH_TIMEOUT_S", None)
        os.environ.pop("RAY_TPU_HEALTH_TIMEOUT_S", None)
