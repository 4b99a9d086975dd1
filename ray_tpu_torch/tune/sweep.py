"""Sweep engine: gang-scheduled multi-trial orchestration.

Where ``tune.Tuner`` drives lightweight single-actor trials, ``Sweep``
drives trials that are each a GANG of TrainWorkers (a ``TorchTrainer``
fit), and wires them into the cluster's control plane:

- **Gang scheduling with admission** — a trial launches only when
  ``train.admission.admit_gang`` says yes twice over: the memory
  planner prices the config onto a GPU (fits + headroom), and the
  head's slice/node tables show enough healthy GPUs free. Admitted
  gangs pack onto idle GPUs concurrently; rejected ones wait in the
  admission queue instead of thrashing the placement layer.
- **Ledger-driven early stopping** — the scheduler (``LedgerASHA``)
  reads per-trial loss/goodput from the head's existing ``train_stats``
  fold (each trial is a train job named ``<sweep>/<trial>``); there is
  NO sweep-private reporting path. Stops at rung boundaries kill the
  gang via ``TorchTrainer.request_stop``.
- **Checkpoint-forked PBT** — an exploit stops the loser, forks the
  winner's newest complete checkpoint manifest into the loser's run
  (``checkpoint.fork`` — a zero-byte content-addressed copy), and
  relaunches the loser with perturbed hyperparameters restoring from
  the forked manifest.
- **Preemption-tolerant migration** — a gang on a draining node takes
  the emergency-checkpoint unwind (train/session.py), and the
  trainer's own retry loop re-places it on healthy GPUs; the sweep
  counts the migration and verifies ≤1 step of ledger loss. Trial
  state transitions are journaled to the head's ``sweeps`` table, so
  a head SIGKILL mid-sweep replays them.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import LedgerASHA, LedgerPBT, STOP
from ray_tpu_torch.tune.search import BasicVariantGenerator

logger = logging.getLogger("ray_tpu_torch.tune")

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class SweepConfig:
    num_samples: int = 8
    metric: str = "loss"        # ledger field: "loss" or "goodput"
    mode: str = "min"
    workers_per_trial: int = 1
    # >0: each worker leases this much of a GPU (ScalingConfig's
    # use_gpu / gpus_per_worker). 0 leases none: a scheduling request
    # only, the train loop still picks its own device.
    gpus_per_worker: float = 0.0
    # Extra per-worker resources (e.g. {"SLICE": 1.0}) merged into the
    # gang's bundles on top of the GPU lease.
    resources_per_worker: dict | None = None
    scheduler: LedgerASHA | None = None
    pbt: LedgerPBT | None = None
    max_steps: int | None = None    # ledger-steps cap per trial
    max_concurrent: int = 0         # 0 → TUNE_MAX_CONCURRENT knob
    plan_kwargs: dict | None = None  # admission memory pricing
    max_failures: int = 4           # per-gang trainer retry budget
    poll_s: float | None = None     # 0 valid; None → TUNE_POLL_S knob
    seed: Any = None


@dataclass
class SweepTrialResult:
    trial_id: str
    config: dict
    state: str
    ledger: dict = field(default_factory=dict)
    checkpoint: str | None = None
    error: str | None = None
    attempts: int = 0
    forked_from: str | None = None


class SweepResult:
    def __init__(self, sweep_id: str, trials: list[SweepTrialResult],
                 metric: str, mode: str, stats: dict):
        self.sweep_id = sweep_id
        self.trials = trials
        self._metric, self._mode = metric, mode
        # makespan / utilization samples / fork+preemption counters
        self.stats = stats

    def __len__(self):
        return len(self.trials)

    def __iter__(self):
        return iter(self.trials)

    def best(self) -> SweepTrialResult:
        ok = [
            t for t in self.trials
            if t.state != ERROR and t.ledger.get(self._metric) is not None
        ]
        if not ok:
            raise ValueError(f"no trial reported ledger {self._metric!r}")
        return (max if self._mode == "max" else min)(
            ok, key=lambda t: t.ledger[self._metric]
        )


class _SweepTrial:
    __slots__ = (
        "trial_id", "config", "job", "state", "trainer", "thread",
        "result", "error", "stop_reason", "attempts_seen",
        "forked_from", "relaunch", "started_ts", "ended_ts",
    )

    def __init__(self, trial_id: str, config: dict, job: str):
        self.trial_id = trial_id
        self.config = config
        self.job = job
        self.state = PENDING
        self.trainer = None
        self.thread: threading.Thread | None = None
        self.result = None
        self.error: str | None = None
        self.stop_reason: str | None = None
        self.attempts_seen = 0
        self.forked_from: str | None = None
        self.relaunch = False
        self.started_ts: float | None = None
        self.ended_ts: float | None = None


class Sweep:
    """Run ``num_samples`` gang trials of ``train_loop`` over
    ``param_space`` (grid_search / Domain values — the same search
    space language as ``tune.Tuner``)."""

    def __init__(
        self,
        train_loop: Callable,
        param_space: dict | None = None,
        *,
        sweep_id: str | None = None,
        storage_path: str = "/tmp/ray_tpu_sweeps",
        config: SweepConfig | None = None,
    ):
        self.train_loop = train_loop
        self.param_space = param_space or {}
        self.cfg = config or SweepConfig()
        self.sweep_id = sweep_id or f"sweep-{int(time.time()) % 100000}"
        self.storage_path = storage_path
        self.trials: list[_SweepTrial] = []
        self.forks = 0
        self.preemptions = 0
        # (ts, free_chips, total_chips) samples for idle accounting
        self.utilization: list[tuple[float, float, float]] = []

    # ------------------------------------------------------- head I/O
    def _head_call(self, method: str, **kw):
        rt = ray_tpu_torch.api._runtime
        return rt.run(rt.core.head.call(method, **kw))

    def _journal_sweep(self, **fields) -> None:
        try:
            self._head_call(
                "sweep_put", sweep_id=self.sweep_id, fields=fields
            )
        except Exception:  # noqa: BLE001 - journaling must not stop trials
            logger.debug("sweep_put failed", exc_info=True)

    def _journal_trial(self, t: _SweepTrial, **extra) -> None:
        fields = {
            "state": t.state,
            "config": dict(t.config),
            "job": t.job,
            "attempts": t.attempts_seen,
            "forked_from": t.forked_from,
            "stop_reason": t.stop_reason,
            "ts": time.time(),
            **extra,
        }
        try:
            self._head_call(
                "sweep_trial",
                sweep_id=self.sweep_id,
                trial_id=t.trial_id,
                fields=fields,
            )
        except Exception:  # noqa: BLE001 - journaling must not stop trials
            logger.debug("sweep_trial failed", exc_info=True)

    def _ledger_rows(self) -> dict[str, dict]:
        """trial_id → public ledger row, via the existing train_stats
        fold (trial jobs are train jobs named <sweep>/<trial>)."""
        try:
            jobs = self._head_call("train_stats").get("jobs", {})
        except Exception:  # noqa: BLE001 - head busy: empty poll
            logger.debug("train_stats poll failed", exc_info=True)
            return {}
        out = {}
        for t in self.trials:
            row = jobs.get(t.job)
            if row is not None:
                out[t.trial_id] = row
        return out

    # ------------------------------------------------------ lifecycle
    def _make_trainer(self, t: _SweepTrial):
        from ray_tpu_torch import train

        gpus = self.cfg.gpus_per_worker
        scaling = train.ScalingConfig(
            num_workers=self.cfg.workers_per_trial,
            use_gpu=gpus > 0,
            gpus_per_worker=gpus,
            resources_per_worker=dict(self.cfg.resources_per_worker or {}),
        )
        run_config = train.RunConfig(
            name=t.job,
            storage_path=self.storage_path,
            failure_config=train.FailureConfig(
                max_failures=self.cfg.max_failures
            ),
            sweep_id=self.sweep_id,
            trial_id=t.trial_id,
            # Fresh trials discover nothing; PBT-relaunched trials pick
            # up the manifest forked into their run name.
            resume_from_checkpoint="auto",
        )
        return train.TorchTrainer(
            self.train_loop,
            train_loop_config=dict(t.config),
            scaling_config=scaling,
            run_config=run_config,
        )

    def _launch(self, t: _SweepTrial) -> None:
        t.trainer = self._make_trainer(t)
        t.state = RUNNING
        t.started_ts = t.started_ts or time.time()
        self._journal_trial(t)

        def body():
            try:
                t.result = t.trainer.fit()
                if t.result.error is not None:
                    t.error = (
                        f"{type(t.result.error).__name__}: "
                        f"{t.result.error}"
                    )
            except Exception as e:  # noqa: BLE001 - thread boundary
                logger.debug("trial %s fit raised", t.trial_id,
                             exc_info=True)
                t.error = f"{type(e).__name__}: {e}"

        t.thread = threading.Thread(
            target=body, name=f"sweep-{t.trial_id}", daemon=True
        )
        t.thread.start()

    def _request_stop(self, t: _SweepTrial, reason: str) -> None:
        t.stop_reason = reason
        if t.trainer is not None:
            t.trainer.request_stop()

    def _reap(self, t: _SweepTrial) -> None:
        """Fold a finished thread into the trial's terminal state (or
        queue a PBT relaunch)."""
        t.thread = None
        if t.relaunch:
            t.relaunch = False
            t.state = PENDING
            t.trainer = None
            t.error = None
            t.stop_reason = None
            return
        t.ended_ts = time.time()
        if t.stop_reason is not None or t.error is None:
            t.state = TERMINATED
        else:
            t.state = ERROR
        self._journal_trial(t)

    def _admit_and_launch(self, pending: list[_SweepTrial]) -> None:
        from ray_tpu_torch._private import config as _config
        from ray_tpu_torch.train import admission

        cap = self.cfg.max_concurrent or _config.get("TUNE_MAX_CONCURRENT")
        running = sum(1 for t in self.trials if t.state == RUNNING)
        try:
            status = self._head_call("cluster_status")
        except Exception:  # noqa: BLE001 - head busy: admit nothing
            logger.debug("cluster_status poll failed", exc_info=True)
            return
        free, total = admission.cluster_chips(status)
        self.utilization.append((time.time(), free, total))
        for t in pending:
            if cap and running >= cap:
                break
            ticket = admission.admit_gang(
                self.cfg.workers_per_trial,
                self.cfg.gpus_per_worker,
                plan_kwargs=self.cfg.plan_kwargs,
                status=status,
            )
            if not ticket:
                if ticket.plan is not None and not ticket.plan.fits:
                    # A config the planner rejects outright never fits
                    # any GPU — waiting won't help.
                    t.state = ERROR
                    t.error = f"admission: {ticket.reason}"
                    self._journal_trial(t)
                    continue
                logger.debug(
                    "trial %s waiting for admission: %s",
                    t.trial_id, ticket.reason,
                )
                break  # FIFO admission: don't starve the head of queue
            # Account the gang's GPUs against this tick's snapshot so
            # several pending trials don't all admit against the same
            # free GPUs.
            nodes = status.get("nodes") or {}
            kind = "GPU" if any(
                (n.get("resources") or {}).get("GPU")
                for n in nodes.values()
            ) else "CPU"
            need = self.cfg.workers_per_trial * self.cfg.gpus_per_worker
            for n in nodes.values():
                avail = n.get("available") or {}
                take = min(need, float(avail.get(kind, 0.0)))
                if take > 0:
                    avail[kind] = float(avail.get(kind, 0.0)) - take
                    need -= take
                if need <= 0:
                    break
            self._launch(t)
            running += 1

    # ---------------------------------------------------------- steps
    def _apply_scheduler(self, rows: dict[str, dict]) -> None:
        sched = self.cfg.scheduler
        by_id = {t.trial_id: t for t in self.trials}
        for tid, row in rows.items():
            t = by_id[tid]
            if t.state != RUNNING:
                continue
            steps = int(row.get("steps") or 0)
            # Migration accounting: each extra ledger attempt is a gang
            # that died (preemption / node loss) and re-admitted.
            attempts = int(row.get("attempts") or 0)
            if attempts > max(1, t.attempts_seen):
                self.preemptions += attempts - max(1, t.attempts_seen)
                t.attempts_seen = attempts
                self._journal_sweep(preemptions=self.preemptions)
                self._journal_trial(t)
            elif attempts > 0:
                t.attempts_seen = attempts
            if self.cfg.max_steps and steps >= self.cfg.max_steps:
                self._request_stop(t, "max_steps")
                continue
            if sched is None:
                continue
            value = row.get(self.cfg.metric)
            if sched.decide(tid, steps, value) == STOP:
                logger.info(
                    "sweep %s: stopping trial %s at rung (steps=%d, "
                    "%s=%s)", self.sweep_id, tid, steps,
                    self.cfg.metric, value,
                )
                self._request_stop(t, "rung")

    def _apply_pbt(self, rows: dict[str, dict]) -> None:
        pbt = self.cfg.pbt
        if pbt is None:
            return
        by_id = {t.trial_id: t for t in self.trials}
        pbt_rows = {
            tid: (int(r.get("steps") or 0), r.get(self.cfg.metric))
            for tid, r in rows.items()
            if by_id[tid].state == RUNNING
        }
        for loser_id, winner_id in pbt.exploit_pairs(pbt_rows):
            loser, winner = by_id[loser_id], by_id[winner_id]
            if loser.state != RUNNING or winner.state != RUNNING:
                continue
            logger.info(
                "sweep %s: PBT exploit — %s forks %s's checkpoint",
                self.sweep_id, loser_id, winner_id,
            )
            loser.relaunch = True
            loser.forked_from = winner_id
            loser.config = pbt.perturb(winner.config)
            self._request_stop(loser, "exploit")

    def _maybe_fork(self, t: _SweepTrial) -> None:
        """Complete a queued PBT exploit after the loser's gang is
        down: fork the winner's newest complete manifest into the
        loser's run (zero bulk bytes) so the relaunch restores it."""
        if t.forked_from is None or t.state != PENDING:
            return
        winner = next(
            (w for w in self.trials if w.trial_id == t.forked_from), None
        )
        if winner is None:
            return
        from ray_tpu_torch import checkpoint as ckpt

        try:
            reply = ckpt.fork(winner.job, t.job)
        except ValueError as e:
            # No complete checkpoint yet: relaunch fresh with the
            # perturbed config — the exploit still moved the
            # hyperparameters.
            logger.info("PBT fork skipped for %s: %s", t.trial_id, e)
            return
        self.forks += 1
        assert reply["new_bytes"] == 0, (
            "content-addressed fork moved bytes: " + repr(reply)
        )
        self._journal_sweep(forks=self.forks)
        self._journal_trial(t, fork_step=reply["step"])

    # ------------------------------------------------------------ run
    def run(self) -> SweepResult:
        from ray_tpu_torch._private import config as _config

        cfg = self.cfg
        poll_s = (
            cfg.poll_s if cfg.poll_s is not None
            else _config.get("TUNE_POLL_S")
        )
        searcher = BasicVariantGenerator(
            self.param_space, num_samples=cfg.num_samples, seed=cfg.seed
        )
        i = 0
        while True:
            trial_id = f"t{i:04d}"
            config = searcher.suggest(trial_id)
            if config is None:
                break
            self.trials.append(
                _SweepTrial(
                    trial_id, config, f"{self.sweep_id}/{trial_id}"
                )
            )
            i += 1
        t0 = time.time()
        self._journal_sweep(
            state=RUNNING,
            num_samples=len(self.trials),
            metric=cfg.metric,
            mode=cfg.mode,
            scheduler=type(cfg.scheduler).__name__
            if cfg.scheduler else None,
            pbt=cfg.pbt is not None,
            workers_per_trial=cfg.workers_per_trial,
            forks=0,
            preemptions=0,
            started_ts=t0,
        )
        for t in self.trials:
            self._journal_trial(t)
        while True:
            # Reap finished gangs (and queue PBT relaunches).
            for t in self.trials:
                if t.thread is not None and not t.thread.is_alive():
                    self._reap(t)
            pending = [t for t in self.trials if t.state == PENDING]
            for t in pending:
                self._maybe_fork(t)
            self._admit_and_launch(pending)
            live = [t for t in self.trials if t.state == RUNNING]
            if not live and not pending:
                break
            rows = self._ledger_rows()
            self._apply_scheduler(rows)
            self._apply_pbt(rows)
            time.sleep(poll_s)
        makespan = time.time() - t0
        self._journal_sweep(
            state="FINISHED", makespan_s=makespan,
            forks=self.forks, preemptions=self.preemptions,
        )
        rows = self._ledger_rows()
        results = [
            SweepTrialResult(
                trial_id=t.trial_id,
                config=dict(t.config),
                state=t.state,
                ledger=rows.get(t.trial_id, {}),
                checkpoint=(
                    t.result.checkpoint if t.result is not None else None
                ),
                error=t.error,
                attempts=t.attempts_seen,
                forked_from=t.forked_from,
            )
            for t in self.trials
        ]
        return SweepResult(
            self.sweep_id, results, cfg.metric, cfg.mode,
            stats={
                "makespan_s": makespan,
                "forks": self.forks,
                "preemptions": self.preemptions,
                "utilization": list(self.utilization),
                "chip_idle_fraction": self.chip_idle_fraction(),
            },
        )

    def chip_idle_fraction(self) -> float | None:
        """Time-weighted mean of free/total chips over the sweep (the
        bench's packing-efficiency number). None without samples."""
        samples = [
            (ts, free, total)
            for ts, free, total in self.utilization
            if total > 0
        ]
        if len(samples) < 2:
            return None
        num = den = 0.0
        for (ts0, free, total), (ts1, _, _) in zip(samples, samples[1:]):
            dt = max(0.0, ts1 - ts0)
            num += (free / total) * dt
            den += dt
        return num / den if den > 0 else None
