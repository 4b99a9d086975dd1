"""The slice as a whole: the same two sweeps run on both packages, and
their outcomes must agree.

- Sweep 1: the ``tiny`` preset on the CPU, a grid of 3 learning rates, 4
  steps per trial, one trial at a time, stopped by ``LedgerASHA`` (grace
  2, factor 2).
- Sweep 2: 2 trials at once under ``LedgerPBT`` (interval 2, quantile
  0.5, one mutation), each saving once, at step 2, into the shard store.
  The exploit forks the winner's checkpoint into the loser's run, and the
  loser relaunches from it with the mutated learning rate.

The JAX package runs its sweeps of ``JaxTrainer`` gangs in a subprocess
with its own runtime, as tests/test_torch_trainer.py does. The port runs
``TorchTrainer`` gangs from the same initial weights (the reference's
``init_params`` tree through ``params_from_jax``) and the same batches.
Per trial, the losses must agree within 1e-4 (fp32). The stopped trials,
the exploit pair and the fork count must be equal.

Both sides use the same rules so that no decision depends on timing:

- The ASHA wrapper (``JudgedASHA``) writes each rung decision to a file.
  A trial that reaches a rung waits for that file. On STOP it waits to
  be stopped.
- A PBT trial reports its checkpointed step only after the save has
  committed and every trial of the sweep has committed it. It then waits
  until the fork is journaled before it steps on.
- A relaunched trial steps only once the trial it forked from has
  ended.
- The two learning rates are far apart. The better one's loss after one
  step is below the shared first loss, and below the other's at every
  step. So the pair is the same whichever steps the ledger shows at the
  exploit, and the winner's later steps cannot make it the loser.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.tune.schedulers import LedgerASHA  # noqa: F401 - JudgedASHA
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent
STEPS, TOTAL, SAVE_AT = 4, 8, 2
ASHA_LRS = [3e-3, 1e-2, 1e-4]
PBT_LRS, PBT_MUTATION = [1e-2, 1e-5], 3e-3
DEADLINE_S = 120.0
LOSS_RTOL = 1e-4

torch.set_num_threads(1)

# The rung-decision recorder, written once and run by both packages.
_JUDGED = '''
class JudgedASHA(LedgerASHA):
    """LedgerASHA that writes each rung decision to <out>/rung-<trial>-<n>
    (the trial loop waits for it)."""

    def __init__(self, out, **kw):
        super().__init__(**kw)
        self.out = out

    def decide(self, trial_id, steps, value):
        before = self._judged.get(trial_id, 0)
        decision = super().decide(trial_id, steps, value)
        rung = self._judged.get(trial_id, 0)
        if rung != before:
            path = f"{self.out}/rung-{trial_id}-{rung}"
            with open(path + ".tmp", "w") as f:
                f.write(decision)
            os.replace(path + ".tmp", path)
        return decision
'''
exec(_JUDGED)  # noqa: S102 - defines JudgedASHA over the port's LedgerASHA

# The train loop's waits, written once and run by both packages' loops
# (``train`` and ``ckpt`` are the package's modules, ``_state`` its
# util.state).
_WAITS = '''
def wait_for(pred, what, deadline_s):
    end = _t.monotonic() + deadline_s
    while not pred():
        if _t.monotonic() > end:
            raise TimeoutError(f"waited {deadline_s} s for {what}")
        _t.sleep(0.05)

def sweep_row(ctx):
    return _state.sweep_stats(sweep_id=ctx.sweep_id)["sweeps"][ctx.sweep_id]

def all_committed(ctx, step):
    jobs = [t["job"] for t in sweep_row(ctx)["trials"].values()]
    return all(ckpt.latest_step(j) == step for j in jobs)

def rung_decision(out, trial_id, rung):
    path = f"{out}/rung-{trial_id}-{rung}"
    if not _os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()
'''

# One trial of either package: ``make_state(lr)``, ``run_step(state, i)``
# -> (state, loss) and ``step_of(state)`` are the package's.
_BODY = '''
def run_trial(config, make_state, run_step, step_of):
    ctx = train.get_context()
    deadline = config["deadline_s"]
    state = make_state(config["lr"])
    uri = train.get_checkpoint()
    if uri is not None:
        state = ckpt.restore_uri(uri, target=state)
        source = sweep_row(ctx)["trials"][ctx.trial_id]["forked_from"]
        wait_for(lambda: sweep_row(ctx)["trials"][source]["state"]
                 == "TERMINATED" or sweep_row(ctx)["trials"][source].get(
                     "forked_from") == ctx.trial_id,
                 "the fork's source to end", deadline)
    saver = ckpt.AsyncCheckpointer() if config.get("save_at") else None
    path = _os.path.join(config["out"], f"{ctx.trial_id}.jsonl")
    for i in range(step_of(state), config["steps"]):
        state, loss = run_step(state, i)
        if saver is not None and i + 1 == config["save_at"]:
            saver.save(i + 1, state)
            saver.wait()
            wait_for(lambda: all_committed(ctx, config["save_at"]),
                     "every trial's checkpoint", deadline)
        with open(path, "a") as f:
            f.write(_json.dumps({"step": i, "loss": loss, "lr": config["lr"],
                                 "restored": uri}) + "\\n")
        train.report({"loss": loss})
        if saver is not None and i + 1 == config["save_at"]:
            wait_for(lambda: sweep_row(ctx).get("forks", 0) >= 1,
                     "the fork", deadline)
        if i + 1 in config.get("rungs", ()):
            wait_for(lambda: rung_decision(config["out"], ctx.trial_id,
                                           i + 1) is not None,
                     f"the decision at rung {i + 1}", deadline)
            if rung_decision(config["out"], ctx.trial_id, i + 1) == "STOP":
                wait_for(lambda: False, "the stop", deadline)
'''


def _port_loop_factory(total):
    waits, body = _WAITS, _BODY

    def loop(config):
        import json as _json
        import os as _os
        import time as _t

        import numpy as np
        import torch

        import ray_tpu_torch.train as train
        from ray_tpu_torch import checkpoint as ckpt
        from ray_tpu_torch.models.llama import PRESETS, params_from_jax
        from ray_tpu_torch.train import step as tstep
        from ray_tpu_torch.util import state as _state

        torch.set_num_threads(1)
        ns = {"train": train, "ckpt": ckpt, "_state": _state, "_t": _t,
              "_os": _os, "_json": _json}
        exec(waits + body, ns)  # noqa: S102 - the loop shared with JAX
        cfg = PRESETS["tiny"]
        with np.load(config["init"]) as z:
            flat = {k: z[k] for k in z.files}
        tree: dict = {}
        for key, value in flat.items():
            node = tree
            *path, last = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[last] = value
        tokens = np.load(config["tokens"])
        steps: dict = {}

        def make_state(lr):
            opt = tstep.make_optimizer(lr=lr, warmup=0, total_steps=total)
            params = params_from_jax(tree, cfg, "cpu")
            for _, t in tstep._flatten(params):
                t.requires_grad_(True)
            steps["fn"] = tstep.jit_train_step(cfg, opt)
            return tstep.TrainState(0, params, opt.init(params))

        def run_step(state, i):
            state, m = steps["fn"](state,
                                   {"tokens": torch.from_numpy(tokens[i])})
            return state, float(m["loss"])

        ns["run_trial"](config, make_state, run_step,
                        lambda s: int(s.step))

    return loop


# The JAX package's side: writes the initial weights and batches, then
# runs both sweeps of JaxTrainer gangs and prints their outcomes.
_REFERENCE = textwrap.dedent('''
    import json, os, sys, time
    import numpy as np
    import jax
    import ray_tpu
    from ray_tpu import tune
    from ray_tpu.models import llama
    from ray_tpu.train import step as jstep
    from ray_tpu.tune.schedulers import LedgerASHA
    from ray_tpu.util import state

    work = sys.argv[1]
    STEPS, TOTAL, SAVE_AT = {steps}, {total}, {save_at}
    WAITS, BODY = {waits!r}, {body!r}
    exec({judged!r})

    def loop(config):
        import json as _json, os as _os, time as _t
        import jax, jax.numpy as jnp, numpy as np
        import ray_tpu.train as train
        from ray_tpu import checkpoint as ckpt
        from ray_tpu.models import llama
        from ray_tpu.train import step as jstep
        from ray_tpu.util import state as _state

        ns = {{"train": train, "ckpt": ckpt, "_state": _state, "_t": _t,
              "_os": _os, "_json": _json}}
        exec(WAITS + BODY, ns)
        cfg = llama.PRESETS["tiny"]
        tokens = np.load(config["tokens"])
        steps = {{}}

        def make_state(lr):
            opt = jstep.make_optimizer(lr=lr, warmup=0, total_steps=TOTAL)
            steps["fn"] = jax.jit(jstep.make_train_step(cfg, opt))
            return jstep.init_train_state(jax.random.key(0), cfg, opt)

        def run_step(state, i):
            state, m = steps["fn"](state, {{"tokens": jnp.asarray(tokens[i])}})
            return state, float(m["loss"])

        ns["run_trial"](config, make_state, run_step,
                        lambda s: int(s.step))

    cfg = llama.PRESETS["tiny"]
    opt = jstep.make_optimizer(lr=1e-3, warmup=0, total_steps=TOTAL)
    params = jstep.init_train_state(jax.random.key(0), cfg, opt).params
    flat = {{}}
    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            flat["/".join(path)] = np.asarray(t)
    walk(params)
    np.save(os.path.join(work, "tokens.npy"), np.random.default_rng(1)
            .integers(0, 16, size=(STEPS, 2, 17)).astype(np.int32))
    np.savez(os.path.join(work, "init.tmp.npz"), **flat)
    os.replace(os.path.join(work, "init.tmp.npz"),
               os.path.join(work, "init.npz"))

    ray_tpu.init(num_cpus=4)
    try:
        out = {{}}
        for name, kw in json.loads(sys.argv[2]).items():
            d = os.path.join(work, "jax-" + name)
            os.makedirs(d)
            space = {{"lr": tune.grid_search(kw.pop("lrs")), "steps": STEPS,
                     "out": d, "init": os.path.join(work, "init.npz"),
                     "tokens": os.path.join(work, "tokens.npy"),
                     "deadline_s": kw.pop("deadline_s"), **kw.pop("space")}}
            sched = kw.pop("asha", None)
            pbt = kw.pop("pbt", None)
            sweep = tune.Sweep(
                loop, space, sweep_id=name,
                storage_path=os.path.join(work, "jax-results"),
                config=tune.SweepConfig(
                    num_samples=1, workers_per_trial=1, chips_per_worker=0.0,
                    scheduler=None if sched is None else JudgedASHA(
                        d, metric="loss", mode="min", **sched),
                    pbt=None if pbt is None else tune.LedgerPBT(
                        metric="loss", mode="min", **pbt),
                    **kw))
            res = sweep.run()
            out[name] = {{
                "states": {{t.trial_id: [t.state, t.error]
                           for t in res.trials}},
                "journal": state.sweep_stats(sweep_id=name)["sweeps"][name],
                "forks": res.stats["forks"],
            }}
        with open(os.path.join(work, "jax.json"), "w") as f:
            json.dump(out, f, default=str)
    finally:
        ray_tpu.shutdown()
''').format(steps=STEPS, total=TOTAL, save_at=SAVE_AT, waits=_WAITS,
            body=_BODY, judged=_JUDGED)


def _sweeps():
    """name -> the sweep's settings, as JSON both sides read."""
    return {
        "asha": {"lrs": ASHA_LRS, "deadline_s": DEADLINE_S,
                 "space": {"rungs": [2, 4]},
                 "asha": {"grace_period": 2, "reduction_factor": 2},
                 "max_concurrent": 1, "poll_s": 0.05},
        "pbt": {"lrs": PBT_LRS, "deadline_s": DEADLINE_S,
                "space": {"save_at": SAVE_AT},
                "pbt": {"perturbation_interval": SAVE_AT,
                        "hyperparam_mutations": {"lr": [PBT_MUTATION]},
                        "quantile_fraction": 0.5, "seed": 3},
                "max_concurrent": 2, "poll_s": 0.05},
    }


def _port_sweeps(work):
    from ray_tpu_torch import tune
    from ray_tpu_torch.util import state

    out = {}
    for name, kw in _sweeps().items():
        d = os.path.join(work, "torch-" + name)
        os.makedirs(d)
        space = {"lr": tune.grid_search(kw.pop("lrs")), "steps": STEPS,
                 "out": d, "init": os.path.join(work, "init.npz"),
                 "tokens": os.path.join(work, "tokens.npy"),
                 "deadline_s": kw.pop("deadline_s"), **kw.pop("space")}
        sched, pbt = kw.pop("asha", None), kw.pop("pbt", None)
        sweep = tune.Sweep(
            _port_loop_factory(TOTAL), space, sweep_id=name,
            storage_path=os.path.join(work, "torch-results"),
            config=tune.SweepConfig(
                num_samples=1, workers_per_trial=1, gpus_per_worker=0.0,
                scheduler=None if sched is None else JudgedASHA(
                    d, metric="loss", mode="min", **sched),
                pbt=None if pbt is None else tune.LedgerPBT(
                    metric="loss", mode="min", **pbt),
                **kw))
        res = sweep.run()
        out[name] = {
            "states": {t.trial_id: [t.state, t.error] for t in res.trials},
            "journal": state.sweep_stats(sweep_id=name)["sweeps"][name],
            "forks": res.stats["forks"],
        }
    return out


def _trial_steps(d):
    """trial id -> {(restored, step): loss} from a sweep's step files."""
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".jsonl"):
            with open(os.path.join(d, name)) as f:
                rows = [json.loads(line) for line in f]
            out[name[:-len(".jsonl")]] = {
                (r["restored"] is not None, r["step"]): (r["loss"], r["lr"])
                for r in rows}
    return out


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


def test_sweeps_match_the_jax_trainer_sweeps(cluster, tmp_path):
    work = str(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAY_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    with open(os.path.join(work, "jax.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, work, json.dumps(_sweeps())],
            env=env, cwd=work, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 120
            while not os.path.exists(os.path.join(work, "init.npz")):
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
            got = _port_sweeps(work)
            proc.wait(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(os.path.join(work, "jax.log")) as f:
        assert proc.returncode == 0, f.read()[-4000:]
    with open(os.path.join(work, "jax.json")) as f:
        want = json.load(f)

    for name in ("asha", "pbt"):
        g, w = got[name], want[name]
        assert all(s == "TERMINATED" and e is None
                   for s, e in g["states"].values()), g["states"]
        assert g["states"] == w["states"]
        assert g["journal"]["state"] == w["journal"]["state"] == "FINISHED"
        g_steps = _trial_steps(os.path.join(work, "torch-" + name))
        w_steps = _trial_steps(os.path.join(work, "jax-" + name))
        assert g_steps.keys() == w_steps.keys() == g["states"].keys()
        for tid in g_steps:
            common = sorted(g_steps[tid].keys() & w_steps[tid].keys())
            assert common and common[0] == (False, 0), (tid, common)
            for key in common:
                (gl, glr), (wl, wlr) = g_steps[tid][key], w_steps[tid][key]
                assert glr == wlr, (name, tid, key)
                assert abs(gl - wl) <= LOSS_RTOL * abs(wl), (
                    name, tid, key, gl, wl)

        def stops(side):
            return sorted(t for t, r in side["journal"]["trials"].items()
                          if r.get("stop_reason") == "rung")

        def pairs(side):
            return sorted((t, r["forked_from"], r.get("fork_step"))
                          for t, r in side["journal"]["trials"].items()
                          if r.get("forked_from"))

        assert stops(g) == stops(w)
        assert pairs(g) == pairs(w)
        assert g["forks"] == w["forks"]
        if name == "asha":
            # Every trial was judged at rung 2 on the same step: the ones
            # stopped there ran exactly 2 steps, the others all 4.
            assert stops(g), "ASHA stopped no trial"
            for tid, steps in g_steps.items():
                ran = sorted(s for _, s in steps)
                assert ran == ([0, 1] if tid in stops(g) else
                               [0, 1, 2, 3]), (tid, ran)
        else:
            assert g["forks"] == 1
            ((loser, winner, fork_step),) = pairs(g)
            assert fork_step == SAVE_AT
            resumed = sorted((s, v) for (r, s), v in g_steps[loser].items()
                             if r)
            assert [s for s, _ in resumed] == list(range(SAVE_AT, STEPS))
            assert all(lr == PBT_MUTATION for _, (_, lr) in resumed)
            # Restored from the winner's weights: its first loss is the
            # winner's at that step.
            won = g_steps[winner][(False, SAVE_AT)][0]
            assert abs(resumed[0][1][0] - won) <= 1e-5 * abs(won)
