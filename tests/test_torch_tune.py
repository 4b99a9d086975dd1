"""tests/test_tune.py's 10 cases on the port: the Tuner's controller and
schedulers (ray_tpu_torch/tune/tuner.py, trial.py, schedulers.py,
callbacks.py) over real trial actors of the port's runtime, with the
same trainables, search spaces and assertions as the JAX package's.
"""

import os

import pytest

from ray_tpu_torch import tune
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


def test_function_trainable_grid(cluster, tmp_path):
    def objective(config):
        score = -((config["x"] - 3) ** 2) + config["b"]
        tune.report({"score": score})

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3, 4]), "b": 10},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="grid", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == 10


def test_random_search_num_samples(cluster, tmp_path):
    def objective(config):
        tune.report({"v": config["lr"]})

    tuner = tune.Tuner(
        objective,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(num_samples=6, metric="v", mode="min",
                                    seed=42),
        run_config=tune.RunConfig(name="rand", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 6
    vals = [r.metrics["v"] for r in grid if not r.error]
    assert all(1e-4 <= v <= 1e-1 for v in vals)
    assert len(set(vals)) > 1


def test_trial_error_isolated(cluster, tmp_path):
    def objective(config):
        if config["x"] == 2:
            raise ValueError("boom")
        tune.report({"ok": 1})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3])},
        run_config=tune.RunConfig(name="err", storage_path=str(tmp_path)),
    ).fit()
    assert len(grid.errors) == 1
    assert "boom" in grid.errors[0].error
    assert sum(1 for r in grid if not r.error) == 2


def test_asha_stops_bad_trials(cluster, tmp_path):
    class Curve(tune.Trainable):
        def setup(self, config):
            self.slope = config["slope"]
            self.t = 0

        def step(self):
            self.t += 1
            return {"score": self.slope * self.t}

    sched = tune.ASHAScheduler(metric="score", mode="max", grace_period=2,
                               reduction_factor=2, max_t=16)
    grid = tune.Tuner(
        Curve,
        param_space={"slope": tune.grid_search([1, 2, 3, 4])},
        tune_config=tune.TuneConfig(scheduler=sched, metric="score",
                                    mode="max", max_iterations=16),
        run_config=tune.RunConfig(name="asha", storage_path=str(tmp_path)),
    ).fit()
    best = grid.get_best_result()
    assert best.config["slope"] == 4
    iters = {r.config["slope"]: r.metrics["training_iteration"] for r in grid}
    # The worst trial must have been stopped before max_t.
    assert iters[1] < 16
    assert iters[4] == 16


def test_function_checkpoint_roundtrip(cluster, tmp_path):
    import json

    def objective(config):
        ckpt_dir = str(tmp_path / "stage")
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "state.json"), "w") as f:
            json.dump({"x": config["x"]}, f)
        tune.report({"score": config["x"]}, checkpoint=ckpt_dir)

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([5])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="ckpt", storage_path=str(tmp_path)),
    ).fit()
    best = grid.get_best_result()
    assert best.checkpoint is not None
    with open(os.path.join(best.checkpoint, "state.json")) as f:
        assert json.load(f) == {"x": 5}


def test_pbt_exploits(cluster, tmp_path):
    class Learner(tune.Trainable):
        def setup(self, config):
            self.lr = config["lr"]
            self.score = getattr(self, "score", 0.0)

        def step(self):
            self.score += self.lr
            return {"score": self.score}

        def save_checkpoint(self, d):
            import json

            with open(os.path.join(d, "s.json"), "w") as f:
                json.dump({"score": self.score}, f)

        def load_checkpoint(self, d):
            import json

            with open(os.path.join(d, "s.json")) as f:
                self.score = json.load(f)["score"]

    sched = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.1, 1.0, 10.0]}, seed=0,
    )
    grid = tune.Tuner(
        Learner,
        param_space={"lr": tune.grid_search([0.1, 10.0])},
        tune_config=tune.TuneConfig(scheduler=sched, metric="score",
                                    mode="max", max_iterations=9,
                                    max_concurrent_trials=2),
        run_config=tune.RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    scores = sorted(r.metrics["score"] for r in grid)
    # The weak trial must have been pulled up by exploitation: with pure
    # lr=0.1 it would end at 0.9; after cloning the strong trial it lands
    # within a perturbation factor of it.
    assert scores[0] > 10.0


def test_dataframe(cluster, tmp_path):
    def objective(config):
        tune.report({"m": config["x"] * 2})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2])},
        run_config=tune.RunConfig(name="df", storage_path=str(tmp_path)),
    ).fit()
    df = grid.get_dataframe()
    assert set(df["config/x"]) == {1, 2}
    assert set(df["m"]) == {2, 4}


def test_hyperband_brackets_trade_exploration(cluster, tmp_path):
    """HyperBand (reference: hyperband.py run as async per-bracket
    halving): the best trial survives to max_t, weak trials in
    aggressive brackets stop early, and different brackets genuinely
    use different rung ladders."""

    class Curve(tune.Trainable):
        def setup(self, config):
            self.slope = config["slope"]
            self.t = 0

        def step(self):
            self.t += 1
            return {"score": self.slope * self.t}

    sched = tune.HyperBandScheduler(
        metric="score", mode="max", grace_period=1,
        reduction_factor=2, max_t=8, num_brackets=3,
    )
    # Brackets ladder at grace 1, 2, 4.
    assert [b.grace for b in sched._brackets] == [1, 2, 4]
    grid = tune.Tuner(
        Curve,
        param_space={
            "slope": tune.grid_search([1, 2, 3, 4, 5, 6])
        },
        tune_config=tune.TuneConfig(
            scheduler=sched, metric="score", mode="max",
            max_iterations=8,
        ),
        run_config=tune.RunConfig(
            name="hb", storage_path=str(tmp_path)
        ),
    ).fit()
    best = grid.get_best_result()
    assert best.config["slope"] == 6
    iters = {
        r.config["slope"]: r.metrics["training_iteration"] for r in grid
    }
    assert iters[6] == 8  # the winner ran to completion
    assert min(iters.values()) < 8  # someone was halved early
    # Round-robin really spread trials over all brackets.
    assert len(set(sched._assignment.values())) == 3


def test_hyperband_degenerate_brackets_pruned():
    """Brackets whose first rung exceeds max_t never halve — they are
    dropped rather than kept as duplicate FIFOs."""
    sched = tune.HyperBandScheduler(
        metric="m", grace_period=4, reduction_factor=4, max_t=8,
        num_brackets=3,
    )
    assert len(sched._brackets) == 1  # grace 16 and 64 rungs pruned


def test_callbacks_and_tracking_integrations(cluster, tmp_path):
    """Callback hooks fire per trial (reference: tune.Callback +
    air/integrations wandb/mlflow): the JSONL logger writes one result
    file per trial, the wandb adapter opens/logs/finishes one run per
    trial, and mlflow gets params + stepped metrics."""
    import json as _json
    import os as _os

    wandb_cb = tune.WandbLoggerCallback(project="p", _force_fake=True)
    mlflow_cb = tune.MLflowLoggerCallback(
        experiment_name="e", _force_fake=True
    )
    json_cb = tune.JsonLoggerCallback()

    def trainable(config):
        for _ in range(3):
            tune.report({"loss": config["x"] * 1.0})

    grid = tune.Tuner(
        trainable,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=tune.RunConfig(
            name="cb", storage_path=str(tmp_path),
            callbacks=(json_cb, wandb_cb, mlflow_cb),
        ),
    ).fit()
    assert len(grid) == 2

    exp_dir = _os.path.join(str(tmp_path), "cb")
    logs = sorted(
        f for f in _os.listdir(exp_dir) if f.endswith(".result.jsonl")
    )
    assert len(logs) == 2
    rows = [
        _json.loads(ln)
        for ln in open(_os.path.join(exp_dir, logs[0]))
    ]
    assert len(rows) == 3 and "loss" in rows[0]

    runs = wandb_cb._wandb.runs
    assert len(runs) == 2
    assert all(r.finished for r in runs)
    assert all(len(r.logged) == 3 for r in runs)
    assert {r.config["x"] for r in runs} == {1, 2}

    ml = mlflow_cb._mlflow
    assert ml.experiment == "e"
    by_name: dict = {}
    for run in ml.runs:
        by_name.setdefault(run["run_name"], []).append(run)
    assert len(by_name) == 2
    # Params logged once per trial; metrics carry steps.
    for name, runs_ in by_name.items():
        assert any(r["params"] for r in runs_)
        steps = [
            s for r in runs_ for (s, _m) in r["metrics"]
        ]
        assert steps and all(s is not None for s in steps)
