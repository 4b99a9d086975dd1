"""Tuner + controller event loop.

Mirrors the reference's Tune v2 control plane (reference:
python/ray/tune/execution/tune_controller.py:68 — an event loop over
trial actors that starts trials up to the resource cap, consumes
results, and applies scheduler decisions; tuner.py Tuner.fit →
ResultGrid). PBT exploitation uses the class-API save/restore path.
"""

from __future__ import annotations

import inspect
import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch import exceptions as _exc
from ray_tpu_torch.tune import schedulers as S
from ray_tpu_torch.tune.search import DEFER, BasicVariantGenerator, Searcher

logger = logging.getLogger("ray_tpu_torch.tune")

# Typed trial-failure classes (reference: the v2 controller's
# failure-policy split, python/ray/train/v2/_internal/execution/
# failure_handling) — each gets a different retry policy:
# - "preempted": the node under the trial was reclaimed. Never the
#   trial's fault; restart unconditionally from its last checkpoint.
# - "infra": actor/object plumbing died (worker crash, object loss,
#   RPC timeout). Retry up to TUNE_INFRA_RETRIES, then give up.
# - "trial": the trainable itself raised. A user bug — retrying
#   re-raises it, so fail fast.
PREEMPTED = "preempted"
INFRA = "infra"
TRIAL = "trial"

_INFRA_TYPES = (
    _exc.WorkerDiedError,
    _exc.ActorDiedError,
    _exc.ObjectLostError,
    _exc.GetTimeoutError,
)


def classify_failure(err: BaseException | str) -> str:
    """Classify a trial failure as PREEMPTED, INFRA, or TRIAL.

    Walks the cause chain (RayTaskError wraps the user exception in
    ``.cause``) so a PreemptedError surfacing through task-error
    plumbing is still recognized as a preemption, not an infra flake.
    """
    seen: set[int] = set()
    cur: BaseException | None = (
        err if isinstance(err, BaseException) else None
    )
    text = str(err)
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if isinstance(cur, _exc.PreemptedError):
            return PREEMPTED
        if isinstance(cur, _INFRA_TYPES):
            return INFRA
        cur = getattr(cur, "cause", None) or getattr(
            cur, "__cause__", None
        )
    if "PreemptedError" in text:
        return PREEMPTED
    if any(t.__name__ in text for t in _INFRA_TYPES):
        return INFRA
    return TRIAL
from ray_tpu_torch.tune.trial import (
    ERROR,
    PENDING,
    RUNNING,
    TERMINATED,
    Trainable,
    Trial,
    TrialActor,
)


@dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 4
    metric: str | None = None
    mode: str = "max"
    scheduler: S.TrialScheduler | None = None
    search_alg: Searcher | None = None
    seed: Any = None
    max_iterations: int | None = None  # class-API step cap


@dataclass
class RunConfig:
    name: str = "tune_run"
    storage_path: str = "/tmp/ray_tpu_results"
    # tune.Callback instances (loggers / experiment trackers — see
    # tune/callbacks.py); hooks fire per trial start/result/complete.
    callbacks: tuple = ()


@dataclass
class TrialResult:
    config: dict
    metrics: dict
    checkpoint: str | None
    path: str
    error: str | None = None


class ResultGrid:
    def __init__(self, results: list[TrialResult], metric=None, mode="max"):
        self._results = results
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self):
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None, mode: str | None = None):
        metric = metric or self._metric
        mode = mode or self._mode
        ok = [r for r in self._results if not r.error and metric in r.metrics]
        if not ok:
            raise ValueError("no successful trial reported " + str(metric))
        return (max if mode == "max" else min)(
            ok, key=lambda r: r.metrics[metric]
        )

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row.update({f"config/{k}": v for k, v in r.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: RunConfig | None = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def fit(self) -> ResultGrid:
        cfg = self.tune_config
        if cfg.search_alg is not None:
            # num_samples bounds TOTAL trials for pluggable searchers
            # (BasicVariant bakes it into its own queue).
            searcher = _CapSamples(cfg.search_alg, cfg.num_samples)
        else:
            searcher = BasicVariantGenerator(
                self.param_space, num_samples=cfg.num_samples, seed=cfg.seed
            )
        scheduler = cfg.scheduler or S.FIFOScheduler()
        exp_dir = os.path.join(self.run_config.storage_path, self.run_config.name)
        os.makedirs(exp_dir, exist_ok=True)
        is_class = inspect.isclass(self.trainable) and issubclass(
            self.trainable, Trainable
        )
        callbacks = list(self.run_config.callbacks)
        for cb in callbacks:
            # Loggers default their output into THIS experiment's dir;
            # re-point auto-filled ones on reuse across fits (a sticky
            # exp_dir would append run B's rows into run A's files).
            if getattr(cb, "exp_dir", "unset") is None or getattr(
                cb, "_auto_exp_dir", False
            ):
                cb.exp_dir = exp_dir
                cb._auto_exp_dir = True
        controller = _TuneController(
            self.trainable, is_class, searcher, scheduler, cfg, exp_dir,
            callbacks=callbacks,
        )
        results = controller.run()
        return ResultGrid(results, metric=cfg.metric, mode=cfg.mode)


class _CapSamples(Searcher):
    """Bound a pluggable searcher to num_samples total suggestions."""

    def __init__(self, searcher: Searcher, num_samples: int):
        self.searcher = searcher
        self.remaining = num_samples

    def suggest(self, trial_id: str):
        if self.remaining <= 0:
            return None
        config = self.searcher.suggest(trial_id)
        if config is not None and config is not DEFER:
            self.remaining -= 1
        return config

    def on_trial_complete(self, trial_id: str, result: dict | None):
        self.searcher.on_trial_complete(trial_id, result)


class _TuneController:
    """(reference: TuneController tune_controller.py:68 — state machine
    stepping trials and consuming results.)"""

    def __init__(self, trainable, is_class, searcher, scheduler, cfg,
                 exp_dir, callbacks=()):
        self.trainable = trainable
        self.is_class = is_class
        self.searcher = searcher
        self.scheduler = scheduler
        self.cfg = cfg
        self.exp_dir = exp_dir
        self.callbacks = list(callbacks)
        self._cb_warned: set = set()
        self.trials: list[Trial] = []
        self._next_id = 0
        self._exhausted = False

    def _cb(self, hook: str, *args) -> None:
        """Fire a callback hook; a logger bug degrades logging, not the
        run — but it is WARNED (once per callback+hook), because a
        silently-swallowed signature error would otherwise produce an
        empty log dir with zero diagnostics."""
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception as e:  # noqa: BLE001
                key = (id(cb), hook)
                if key not in self._cb_warned:
                    self._cb_warned.add(key)
                    logger.warning(
                        "callback %s.%s failed (suppressed): %r",
                        type(cb).__name__, hook, e,
                    )

    def _new_trial(self) -> Trial | None:
        trial_id = f"t{self._next_id:04d}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            self._exhausted = True
            return None
        if config is DEFER:  # not now (concurrency-limited) — retry later
            return None
        trial = Trial(
            trial_id, config,
            os.path.join(self.exp_dir, f"trial_{self._next_id:04d}"),
        )
        self._next_id += 1
        self.trials.append(trial)
        return trial

    def _start(self, trial: Trial):
        trial.actor = TrialActor.remote(trial.local_dir)
        trial.is_class_api = self.is_class
        if self.is_class:
            ray_tpu_torch.get(trial.actor.setup_class.remote(
                self.trainable, trial.config, trial.checkpoint))
        else:
            ray_tpu_torch.get(trial.actor.start_fn.remote(
                self.trainable, trial.config, trial.checkpoint))
        trial.status = RUNNING
        self._cb("on_trial_start", trial.trial_id, trial.config)

    def _finish(self, trial: Trial, status: str, error: str | None = None):
        trial.status = status
        trial.error = error
        self._cb(
            "on_trial_complete", trial.trial_id,
            trial.last_result if error is None else None, error,
        )
        # Feed the searcher so adaptive algorithms learn from outcomes
        # (reference: SearchAlgorithm.on_trial_complete, tune/search/).
        try:
            self.searcher.on_trial_complete(
                trial.trial_id, trial.last_result if error is None else None
            )
        except Exception:  # noqa: BLE001 - searcher bugs must not kill the run
            logger.warning(
                "searcher.on_trial_complete failed for %s; later "
                "suggestions may ignore this result", trial.trial_id,
                exc_info=True,
            )
        if trial.actor is not None:
            try:
                if trial.is_class_api:
                    ray_tpu_torch.get(trial.actor.shutdown.remote())
                ray_tpu_torch.kill(trial.actor)
            # tpulint: allow(broad-except reason=the trial actor is expected to be dead on the error path; a second kill has nothing to report)
            except Exception:  # noqa: BLE001 - actor may already be dead
                pass
            trial.actor = None

    def _handle_trial_failure(self, trial: Trial, err: Exception):
        """Apply the typed failure policy (see classify_failure)."""
        from ray_tpu_torch._private import config as _config

        kind = classify_failure(err)
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            # tpulint: allow(broad-except reason=the failed trial's actor is usually already dead; the kill is best-effort cleanup)
            except Exception:  # noqa: BLE001
                pass
            trial.actor = None
        if kind == PREEMPTED:
            logger.warning(
                "trial %s preempted (attempt %d); restarting from %s",
                trial.trial_id, trial.infra_retries + 1,
                trial.checkpoint or "scratch",
            )
            self._start(trial)
            return
        if kind == INFRA:
            budget = _config.get("TUNE_INFRA_RETRIES")
            if trial.infra_retries < budget:
                trial.infra_retries += 1
                logger.warning(
                    "trial %s hit infra failure %s (retry %d/%d): %s",
                    trial.trial_id, type(err).__name__,
                    trial.infra_retries, budget, err,
                )
                self._start(trial)
                return
            logger.error(
                "trial %s exhausted %d infra retries; failing: %s",
                trial.trial_id, budget, err,
            )
            self._finish(trial, ERROR, error=f"[infra] {err}")
            return
        # Trial-code bug: retrying would just re-raise it.
        logger.error(
            "trial %s failed in trial code; failing fast: %s",
            trial.trial_id, err,
        )
        self._finish(trial, ERROR, error=f"[trial] {err}")

    def _running(self):
        return [t for t in self.trials if t.status == RUNNING]

    def _run_inner(self) -> list:
        cap = max(1, self.cfg.max_concurrent_trials)
        while True:
            # Fill free slots.
            while not self._exhausted and len(self._running()) < cap:
                t = self._new_trial()
                if t is None:
                    break
                self._start(t)
            running = self._running()
            if not running:
                if self._exhausted:
                    break
                time.sleep(0.05)  # deferred suggestions: retry shortly
                continue
            if self.is_class:
                self._step_class_trials(running)
            else:
                self._poll_fn_trials(running)
        results = [
            TrialResult(
                config=t.config, metrics=t.last_result,
                checkpoint=t.checkpoint, path=t.local_dir, error=t.error,
            )
            for t in self.trials
        ]
        return results

    def run(self) -> list:
        try:
            return self._run_inner()
        finally:
            # Teardown hooks must fire even when a trial actor dies on
            # an unguarded path — otherwise log files stay open and
            # tracker runs are left dangling.
            self._cb(
                "on_experiment_end",
                [
                    TrialResult(
                        config=t.config, metrics=t.last_result,
                        checkpoint=t.checkpoint, path=t.local_dir,
                        error=t.error,
                    )
                    for t in self.trials
                ],
            )

    # ------------------------------------------------------- class API
    def _step_class_trials(self, running: list):
        # One synchronous step per running trial per tick; all results are
        # recorded before any decision so rung/quantile comparisons see
        # every peer at the same milestone (schedulers' two-phase hook).
        step_refs = [(t, t.actor.train_step.remote()) for t in running]
        batch = []
        for t, ref in step_refs:
            try:
                metrics = ray_tpu_torch.get(ref)
            # tpulint: allow(broad-except reason=the failure is classified and either retried or recorded as the trial's terminal error)
            except Exception as e:  # noqa: BLE001
                self._handle_trial_failure(t, e)
                continue
            t.iteration = metrics.get("training_iteration", t.iteration + 1)
            t.results.append(metrics)
            t.last_result = metrics
            self._cb("on_trial_result", t.trial_id, t.config, metrics)
            batch.append((t, metrics))
        decisions = self.scheduler.on_batch(batch, self.trials)
        max_it = self.cfg.max_iterations
        for t, metrics in batch:
            decision = decisions.get(t.trial_id, S.CONTINUE)
            if decision == S.STOP or (max_it and t.iteration >= max_it):
                t.checkpoint = ray_tpu_torch.get(t.actor.save.remote())
                self._finish(t, TERMINATED)
            elif decision == S.EXPLOIT:
                self._exploit(t)

    def _exploit(self, trial: Trial):
        """PBT: clone a top trial's checkpoint + perturbed config
        (reference: pbt.py _exploit)."""
        source = self.scheduler.choose_exploit_source(trial, self._running())
        if source is None or source.actor is None:
            return
        ckpt = ray_tpu_torch.get(source.actor.save.remote())
        new_config = self.scheduler.perturb(source.config)
        trial.config = new_config
        ray_tpu_torch.get(trial.actor.restore.remote(
            ckpt, config=new_config, iteration=source.iteration))
        trial.iteration = source.iteration

    # ---------------------------------------------------- function API
    def _poll_fn_trials(self, running: list):
        time.sleep(0.05)
        polls = [(t, t.actor.poll.remote()) for t in running]
        for t, ref in polls:
            try:
                out = ray_tpu_torch.get(ref)
            # tpulint: allow(broad-except reason=the failure is classified and either retried or recorded as the trial's terminal error)
            except Exception as e:  # noqa: BLE001
                self._handle_trial_failure(t, e)
                continue
            stopped = False
            for entry in out["reports"]:
                metrics = entry["metrics"]
                t.iteration = metrics.get("training_iteration", t.iteration + 1)
                metrics.setdefault("training_iteration", t.iteration)
                t.results.append(metrics)
                t.last_result = metrics
                self._cb(
                    "on_trial_result", t.trial_id, t.config, metrics
                )
                if "checkpoint" in entry:
                    t.checkpoint = entry["checkpoint"]
                decision = self.scheduler.on_result(t, metrics, self.trials)
                if decision == S.STOP:
                    ray_tpu_torch.get(t.actor.stop_fn.remote())
                    self._finish(t, TERMINATED)
                    stopped = True
                    break
            if stopped:
                continue
            if out["done"]:
                t.checkpoint = out["checkpoint"] or t.checkpoint
                if out["error"]:
                    # The fn session reports failures as strings;
                    # classify by name so a preemption surfacing
                    # through the session still restarts the trial.
                    kind = classify_failure(out["error"])
                    if kind == PREEMPTED:
                        logger.warning(
                            "trial %s preempted (reported); restarting "
                            "from %s", t.trial_id,
                            t.checkpoint or "scratch",
                        )
                        if t.actor is not None:
                            try:
                                ray_tpu_torch.kill(t.actor)
                            # tpulint: allow(broad-except reason=the preempted trial's actor is usually already dead; the kill is best-effort cleanup)
                            except Exception:  # noqa: BLE001
                                pass
                            t.actor = None
                        self._start(t)
                    else:
                        self._finish(
                            t, ERROR, error=f"[{kind}] {out['error']}"
                        )
                else:
                    self._finish(t, TERMINATED)
