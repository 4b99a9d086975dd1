"""Tune run callbacks + experiment-tracking integrations.

Reference: tune's Callback seam (python/ray/tune/callback.py) and the
AIR integrations (python/ray/air/integrations/wandb.py, mlflow.py) —
per-trial lifecycle hooks that loggers and trackers attach to. The
wandb/mlflow adapters follow the Optuna-adapter pattern used across
this repo: when the library is installed its real client is driven;
otherwise a faithful in-module fake implements the same init/log/
finish (run/metric/param) surface so the adapter code path is
identical and testable in this zero-egress image.

Usage::

    tune.Tuner(
        trainable,
        run_config=tune.RunConfig(
            callbacks=[tune.JsonLoggerCallback(),
                       tune.WandbLoggerCallback(project="exp")],
        ),
        ...,
    )
"""

from __future__ import annotations

import json
import os
from typing import Any


class Callback:
    """Per-trial lifecycle hooks (reference: tune.Callback). All hooks
    are optional; the controller warns-and-continues on callback
    exceptions (a logger bug degrades logging, not the run)."""

    def on_trial_start(self, trial_id: str, config: dict) -> None:
        pass

    def on_trial_result(
        self, trial_id: str, config: dict, result: dict
    ) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: "dict | None",
        error: "str | None" = None,
    ) -> None:
        pass

    def on_experiment_end(self, results: list) -> None:
        pass


class JsonLoggerCallback(Callback):
    """One JSONL of results per trial under the experiment dir
    (reference: tune's JsonLoggerCallback result.json)."""

    def __init__(self, exp_dir: "str | None" = None):
        self.exp_dir = exp_dir  # filled by the controller when None
        self._files: dict[str, Any] = {}

    def _file(self, trial_id: str):
        f = self._files.get(trial_id)
        if f is None:
            os.makedirs(self.exp_dir, exist_ok=True)
            f = open(
                os.path.join(self.exp_dir, f"{trial_id}.result.jsonl"),
                "a",
            )
            self._files[trial_id] = f
        return f

    def on_trial_result(self, trial_id, config, result):
        f = self._file(trial_id)
        f.write(json.dumps({"config": config, **result}, default=str))
        f.write("\n")
        f.flush()

    def on_experiment_end(self, results):
        for f in self._files.values():
            f.close()
        self._files = {}


# ----------------------------------------------------------- wandb
class _FakeWandbRun:
    def __init__(self, project, name, config):
        self.project = project
        self.name = name
        self.config = dict(config or {})
        self.logged: list[dict] = []
        self.finished = False

    def log(self, metrics: dict) -> None:
        self.logged.append(dict(metrics))

    def finish(self) -> None:
        self.finished = True


class _FakeWandb:
    """Faithful init/log/finish surface of the wandb client."""

    def __init__(self):
        self.runs: list[_FakeWandbRun] = []

    def init(self, project=None, name=None, config=None, **_kw):
        run = _FakeWandbRun(project, name, config)
        self.runs.append(run)
        return run


class WandbLoggerCallback(Callback):
    """Stream every trial's results to a wandb run (reference:
    air/integrations/wandb.py WandbLoggerCallback — one run per trial,
    config as run config, metrics via run.log)."""

    def __init__(self, project: str = "ray_tpu_torch", *, _force_fake=False):
        self.project = project
        if _force_fake:
            self._wandb, self.using_fake = _FakeWandb(), True
        else:
            try:
                import wandb  # noqa: PLC0415

                self._wandb, self.using_fake = wandb, False
            except ImportError:
                self._wandb, self.using_fake = _FakeWandb(), True
        self._runs: dict[str, Any] = {}

    def on_trial_start(self, trial_id, config):
        # reinit="create_new": concurrent trials each keep a LIVE run —
        # legacy reinit=True finishes the previous run, silently
        # dropping every earlier trial's remaining metrics.
        self._runs[trial_id] = self._wandb.init(
            project=self.project, name=trial_id, config=config,
            reinit="create_new",
        )

    def on_trial_result(self, trial_id, config, result):
        run = self._runs.get(trial_id)
        if run is not None:
            run.log(
                {
                    k: v
                    for k, v in result.items()
                    if isinstance(v, (int, float))
                }
            )

    def on_trial_complete(self, trial_id, result, error=None):
        run = self._runs.pop(trial_id, None)
        if run is not None:
            run.finish()


# ---------------------------------------------------------- mlflow
class _FakeMlflowRunHandle:
    class _Info:
        def __init__(self, run_id):
            self.run_id = run_id

    def __init__(self, run_id):
        self.info = self._Info(run_id)


class _FakeMlflow:
    """Faithful experiment/run/log surface of the mlflow client,
    including run RESUMPTION by run_id (start_run(run_id=...))."""

    def __init__(self):
        self.experiment = None
        self.runs: list[dict] = []
        self._by_id: dict[str, dict] = {}
        self._active: "dict | None" = None

    def set_experiment(self, name):
        self.experiment = name

    def start_run(self, run_name=None, run_id=None):
        if run_id is not None:
            self._active = self._by_id[run_id]
            self._active["ended"] = False
        else:
            run_id = f"run{len(self.runs)}"
            self._active = {
                "run_id": run_id, "run_name": run_name,
                "params": {}, "metrics": [], "ended": False,
            }
            self.runs.append(self._active)
            self._by_id[run_id] = self._active
        return _FakeMlflowRunHandle(self._active["run_id"])

    def log_params(self, params):
        self._active["params"].update(params)

    def log_metrics(self, metrics, step=None):
        self._active["metrics"].append((step, dict(metrics)))

    def end_run(self):
        if self._active is not None:
            self._active["ended"] = True
            self._active = None


class MLflowLoggerCallback(Callback):
    """Per-trial MLflow runs with params + stepped metrics (reference:
    air/integrations/mlflow.py MLflowLoggerCallback)."""

    def __init__(
        self, experiment_name: str = "ray_tpu_torch", *, _force_fake=False
    ):
        self.experiment_name = experiment_name
        if _force_fake:
            self._mlflow, self.using_fake = _FakeMlflow(), True
        else:
            try:
                import mlflow  # noqa: PLC0415

                self._mlflow, self.using_fake = mlflow, False
            except ImportError:
                self._mlflow, self.using_fake = _FakeMlflow(), True
        self._mlflow.set_experiment(self.experiment_name)
        self._run_ids: dict[str, str] = {}

    def on_trial_start(self, trial_id, config):
        # ONE mlflow run per trial, resumed by run_id on every later
        # report — mlflow's module API keeps a single active run, and
        # start_run(run_name=...) would CREATE a new run each call,
        # fragmenting a trial into per-point runs.
        run = self._mlflow.start_run(run_name=trial_id)
        self._run_ids[trial_id] = run.info.run_id
        self._mlflow.log_params(
            {k: str(v) for k, v in config.items()}
        )
        self._mlflow.end_run()

    def on_trial_result(self, trial_id, config, result):
        run_id = self._run_ids.get(trial_id)
        if run_id is None:
            return
        self._mlflow.start_run(run_id=run_id)
        self._mlflow.log_metrics(
            {
                k: float(v)
                for k, v in result.items()
                if isinstance(v, (int, float))
            },
            step=result.get("training_iteration"),
        )
        self._mlflow.end_run()

    def on_trial_complete(self, trial_id, result, error=None):
        self._run_ids.pop(trial_id, None)
