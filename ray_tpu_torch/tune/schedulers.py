"""Trial schedulers: early stopping and population-based training.

Mirrors the reference's scheduler surface (reference:
python/ray/tune/schedulers/ — ASHAScheduler async_hyperband.py,
MedianStoppingRule median_stopping_rule.py, PopulationBasedTraining
pbt.py) on the reduced Trial model in this package. Decisions are made
per reported result: CONTINUE, STOP, or (PBT) EXPLOIT.
"""

from __future__ import annotations

import math
import random
from typing import Any

CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"


class TrialScheduler:
    """Two-phase protocol: _record ingests a result, _decide returns a
    decision. The controller batch-records all results from a lockstep
    tick before deciding, so rung comparisons see every peer that
    reached the milestone in the same tick."""

    def _record(self, trial, result: dict) -> None:
        pass

    def _decide(self, trial, result: dict, trials: list) -> str:
        return CONTINUE

    def on_result(self, trial, result: dict, trials: list) -> str:
        self._record(trial, result)
        return self._decide(trial, result, trials)

    def on_batch(self, batch: list, trials: list) -> dict:
        for tr, res in batch:
            self._record(tr, res)
        return {
            tr.trial_id: self._decide(tr, res, trials) for tr, res in batch
        }

    def choose_exploit_source(self, trial, trials: list):
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference: async_hyperband.py).

    Rungs at grace_period * reduction_factor**k; a trial reaching a rung
    stops unless its metric is in the top 1/reduction_factor of results
    recorded at that rung so far.
    """

    def __init__(self, metric: str, mode: str = "max", time_attr: str =
                 "training_iteration", grace_period: int = 1,
                 reduction_factor: int = 4, max_t: int = 100):
        assert mode in ("max", "min")
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.grace, self.rf, self.max_t = grace_period, reduction_factor, max_t
        self._rungs: dict[int, list[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self._milestones = milestones

    def _record(self, trial, result: dict) -> None:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return
        if t in self._milestones:
            self._rungs.setdefault(t, []).append(float(v))

    def _decide(self, trial, result: dict, trials: list) -> str:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        if t in self._milestones:
            rung = self._rungs.get(t, [])
            if rung:
                k = max(1, len(rung) // self.rf)
                top = sorted(rung, reverse=(self.mode == "max"))[:k]
                worst_top = top[-1]
                good = (v >= worst_top) if self.mode == "max" else (v <= worst_top)
                if not good:
                    return STOP
        return CONTINUE


class HyperBandScheduler(TrialScheduler):
    """HyperBand (Li et al. 2018): multiple successive-halving BRACKETS
    with different exploration/exploitation trade-offs — bracket s
    starts its rung ladder at ``grace_period * reduction_factor**s``,
    so some trials get long uninterrupted budgets while others face
    aggressive early halving (reference: hyperband.py; run
    asynchronously per bracket the way the reference's
    ASHAScheduler(brackets=N) does, which fits this package's
    per-result decision seam — synchronous band barriers would need a
    PAUSE decision the Trial model deliberately omits).

    Trials are assigned to brackets round-robin at their first result.
    """

    def __init__(self, metric: str, mode: str = "max", time_attr: str =
                 "training_iteration", grace_period: int = 1,
                 reduction_factor: int = 3, max_t: int = 81,
                 num_brackets: int = 3):
        assert mode in ("max", "min")
        assert num_brackets >= 1
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self._brackets = [
            ASHAScheduler(
                metric, mode=mode, time_attr=time_attr,
                grace_period=grace_period * reduction_factor**s,
                reduction_factor=reduction_factor, max_t=max_t,
            )
            for s in range(num_brackets)
        ]
        # Drop brackets whose first rung already exceeds max_t (they
        # would never halve — pure FIFO copies of each other).
        self._brackets = [
            b for b in self._brackets if b._milestones
        ] or self._brackets[:1]
        self._assignment: dict[str, int] = {}
        self._next = 0

    def bracket_of(self, trial) -> "ASHAScheduler":
        idx = self._assignment.get(trial.trial_id)
        if idx is None:
            idx = self._next % len(self._brackets)
            self._assignment[trial.trial_id] = idx
            self._next += 1
        return self._brackets[idx]

    def _record(self, trial, result: dict) -> None:
        self.bracket_of(trial)._record(trial, result)

    def _decide(self, trial, result: dict, trials: list) -> str:
        return self.bracket_of(trial)._decide(trial, result, trials)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages at the same step (reference:
    median_stopping_rule.py)."""

    def __init__(self, metric: str, mode: str = "max", time_attr: str =
                 "training_iteration", grace_period: int = 1,
                 min_samples_required: int = 3):
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: dict[str, tuple[float, int]] = {}  # trial_id → (sum, n)

    def _record(self, trial, result: dict) -> None:
        v = result.get(self.metric)
        if v is None:
            return
        s, n = self._avgs.get(trial.trial_id, (0.0, 0))
        self._avgs[trial.trial_id] = (s + float(v), n + 1)

    def _decide(self, trial, result: dict, trials: list) -> str:
        t = result.get(self.time_attr, 0)
        v = result.get(self.metric)
        if v is None:
            return CONTINUE
        if t < self.grace:
            return CONTINUE
        others = [
            s_ / n_ for tid, (s_, n_) in self._avgs.items()
            if tid != trial.trial_id and n_ > 0
        ]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        s, n = self._avgs[trial.trial_id]
        avg = s / n
        bad = (avg < median) if self.mode == "max" else (avg > median)
        return STOP if bad else CONTINUE


class LedgerASHA:
    """ASHA over the head's goodput ledger (tune/sweep.py's early
    stopper). Instead of per-result callbacks, the sweep orchestrator
    polls ``train_stats`` and feeds each trial's ledger row —
    ``(steps, value)`` where value is the folded ``loss`` (or any
    ledger field) — into :meth:`decide`. Rungs are step counts
    (``grace_period * reduction_factor**k``); a trial crossing a rung
    is stopped unless its value ranks in the top
    ``1/reduction_factor`` of everything recorded at that rung so far.
    No new reporting path: the values come from the ``train:step``
    span fold."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 2, reduction_factor: int = 4,
                 max_t: int = 10**9):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.grace, self.rf, self.max_t = (
            grace_period, reduction_factor, max_t,
        )
        milestones = []
        t = grace_period
        while t < max_t and len(milestones) < 64:
            milestones.append(t)
            t *= reduction_factor
        self._milestones = milestones
        self._rungs: dict[int, list[float]] = {}
        # trial_id → highest milestone already judged (each rung is
        # crossed once, however often the ledger is polled).
        self._judged: dict[str, int] = {}

    def decide(self, trial_id: str, steps: int, value: float | None) -> str:
        """CONTINUE or STOP for one ledger row."""
        if steps >= self.max_t:
            return STOP
        if value is None:
            return CONTINUE
        crossed = [
            m for m in self._milestones
            if m <= steps and m > self._judged.get(trial_id, 0)
        ]
        if not crossed:
            return CONTINUE
        rung = crossed[-1]  # judge at the highest newly-crossed rung
        self._judged[trial_id] = rung
        peers = self._rungs.setdefault(rung, [])
        peers.append(float(value))
        k = max(1, len(peers) // self.rf)
        top = sorted(peers, reverse=(self.mode == "max"))[:k]
        worst_top = top[-1]
        good = (
            (value >= worst_top) if self.mode == "max"
            else (value <= worst_top)
        )
        return CONTINUE if good else STOP


class LedgerPBT:
    """Population-based training over the ledger (tune/sweep.py's fork
    driver; Jaderberg et al., arXiv:1711.09846). Every
    ``perturbation_interval`` ledger steps a bottom-quantile trial is
    stopped, its run FORKS the winner's checkpoint manifest (a
    zero-byte content-addressed copy — checkpoint/fork.py), and it
    relaunches with the winner's config perturbed."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25, seed=None):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self._last_exploit: dict[str, int] = {}  # trial_id → steps

    def exploit_pairs(
        self, rows: dict[str, tuple[int, float | None]]
    ) -> list[tuple[str, str]]:
        """(loser, winner) pairs due for an exploit, given the current
        ledger rows {trial_id: (steps, value)}. A loser exploits at
        most once per interval window."""
        scored = [
            (v, tid) for tid, (s, v) in rows.items() if v is not None
        ]
        if len(scored) < 2:
            return []
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        winners = [tid for _, tid in scored[:k]]
        losers = {tid for _, tid in scored[-k:]}
        out = []
        for tid, (steps, v) in rows.items():
            if tid not in losers or v is None:
                continue
            if steps - self._last_exploit.get(tid, 0) < self.interval:
                continue
            cands = [w for w in winners if w != tid]
            if not cands:
                continue
            self._last_exploit[tid] = steps
            out.append((tid, self.rng.choice(cands)))
        return out

    def perturb(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            else:  # numeric: jitter
                factor = self.rng.choice([0.8, 1.2])
                out[key] = out.get(key, spec) * factor
        return out


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: pbt.py): every perturbation_interval steps, a
    bottom-quantile trial clones a top-quantile trial's checkpoint and
    perturbs its hyperparameters (resample or *1.2 / *0.8)."""

    def __init__(self, metric: str, mode: str = "max", time_attr: str =
                 "training_iteration", perturbation_interval: int = 5,
                 hyperparam_mutations: dict | None = None,
                 quantile_fraction: float = 0.25, seed=None):
        self.metric, self.mode, self.time_attr = metric, mode, time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self._last: dict[str, float] = {}  # trial_id → last metric

    def _record(self, trial, result: dict) -> None:
        v = result.get(self.metric)
        if v is not None:
            self._last[trial.trial_id] = float(v)

    def _decide(self, trial, result: dict, trials: list) -> str:
        t = result.get(self.time_attr, 0)
        if t == 0 or t % self.interval != 0:
            return CONTINUE
        scored = [
            (self._last[tr.trial_id], tr) for tr in trials
            if tr.trial_id in self._last
        ]
        if len(scored) < 2:
            return CONTINUE
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        bottom_ids = {tr.trial_id for _, tr in scored[-k:]}
        if trial.trial_id in bottom_ids:
            return EXPLOIT
        return CONTINUE

    def choose_exploit_source(self, trial, trials: list):
        scored = [
            (self._last[tr.trial_id], tr) for tr in trials
            if tr.trial_id in self._last and tr.trial_id != trial.trial_id
        ]
        if not scored:
            return None
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        return self.rng.choice([tr for _, tr in scored[:k]])

    def perturb(self, config: dict) -> dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            else:  # numeric: jitter
                factor = self.rng.choice([0.8, 1.2])
                out[key] = out.get(key, spec) * factor
        return out
