"""OptunaSearch: drive Tune trials from an optuna study.

Mirrors the reference adapter (reference:
python/ray/tune/search/optuna/optuna_search.py:1 OptunaSearch — convert
the Tune search space to optuna distributions, study.ask() per suggest,
study.tell() per completion) over this package's Searcher seam
(tune/search.py). When optuna is not installed, a faithful in-module
fake implements the same ask/tell study surface (create_study,
FloatDistribution/IntDistribution/CategoricalDistribution, Trial) so
the adapter code path — space conversion, trial bookkeeping, direction
mapping — is identical and testable either way; with optuna on the
path, its real TPE sampler drives the suggestions.
"""

from __future__ import annotations

import math
import random
from typing import Any

from ray_tpu_torch.tune.search import (
    Choice,
    Domain,
    LogUniform,
    RandInt,
    Searcher,
    Uniform,
)


# --------------------------------------------------------------- fake
# Minimal optuna surface: enough of study.ask/tell for the adapter.
# Sampling is TPE-flavored (split observations at the median, sample
# near a good observation) so the fake's behavior is directionally
# faithful, not just random.
class _FloatDistribution:
    def __init__(self, low: float, high: float, log: bool = False):
        self.low, self.high, self.log = low, high, log


class _IntDistribution:
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high


class _CategoricalDistribution:
    def __init__(self, choices):
        self.choices = list(choices)


class _FakeTrial:
    def __init__(self, number: int, params: dict):
        self.number = number
        self.params = params


class _FakeStudy:
    def __init__(self, direction: str, seed=None):
        self.direction = direction
        self._rng = random.Random(seed)
        self._trials: dict[int, _FakeTrial] = {}
        self._told: list[tuple[dict, float]] = []
        self._n = 0
        self.best_trial: _FakeTrial | None = None
        self._best_value = math.inf

    def _sample(self, name: str, dist) -> Any:
        good = self._good_observations(name)
        if good and self._rng.random() < 0.7:
            # Perturb a good observation (TPE-flavored exploitation).
            base = self._rng.choice(good)
            if isinstance(dist, _CategoricalDistribution):
                return base
            if isinstance(dist, _IntDistribution):
                span = max(1, (dist.high - dist.low) // 8)
                return min(
                    dist.high,
                    max(dist.low, base + self._rng.randint(-span, span)),
                )
            lo, hi = dist.low, dist.high
            if dist.log:
                lo, hi, base = math.log(lo), math.log(hi), math.log(base)
            sigma = (hi - lo) / 10
            x = self._rng.gauss(base, sigma)
            if dist.log:
                x = math.exp(x)
            # Clamp in ORIGINAL space: exp(log(high)) can exceed high.
            return min(dist.high, max(dist.low, x))
        if isinstance(dist, _CategoricalDistribution):
            return self._rng.choice(dist.choices)
        if isinstance(dist, _IntDistribution):
            return self._rng.randint(dist.low, dist.high)
        if dist.log:
            x = math.exp(
                self._rng.uniform(math.log(dist.low), math.log(dist.high))
            )
            return min(dist.high, max(dist.low, x))
        return self._rng.uniform(dist.low, dist.high)

    def _good_observations(self, name: str) -> list:
        if len(self._told) < 4:
            return []
        ordered = sorted(
            self._told,
            key=lambda pv: pv[1],
            reverse=(self.direction == "maximize"),
        )
        # TPE-style gamma: the good set is the top quartile.
        top = ordered[: max(1, len(ordered) // 4)]
        return [p[name] for p, _ in top if name in p]

    def ask(self, distributions: dict) -> _FakeTrial:
        params = {
            name: self._sample(name, dist)
            for name, dist in distributions.items()
        }
        trial = _FakeTrial(self._n, params)
        self._trials[self._n] = trial
        self._n += 1
        return trial

    def tell(self, trial: _FakeTrial, value: float) -> None:
        self._told.append((trial.params, value))
        key = -value if self.direction == "maximize" else value
        if key < self._best_value:
            self._best_value = key
            self.best_trial = trial


class _FakeOptuna:
    FloatDistribution = _FloatDistribution
    IntDistribution = _IntDistribution
    CategoricalDistribution = _CategoricalDistribution

    @staticmethod
    def create_study(direction: str = "minimize", sampler=None, seed=None):
        return _FakeStudy(direction, seed=seed)


def _load_optuna(force_fake: bool):
    if force_fake:
        return _FakeOptuna, True
    try:
        import optuna  # noqa: PLC0415

        return optuna, False
    except ImportError:
        return _FakeOptuna, True


# ------------------------------------------------------------ adapter
class OptunaSearch(Searcher):
    """Suggest Tune configs from an optuna study (ask/tell protocol).

    param_space uses this package's Domain objects (uniform, loguniform,
    randint, choice) or plain constants; grid_search axes are not
    supported here (use BasicVariantGenerator for grids), matching the
    reference adapter's behavior.
    """

    def __init__(
        self,
        param_space: dict,
        *,
        metric: str = "loss",
        mode: str = "min",
        seed=None,
        _force_fake: bool = False,
    ):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self._optuna, self.using_fake = _load_optuna(_force_fake)
        self.metric = metric
        self.mode = mode
        self._constants: dict[str, Any] = {}
        self._distributions: dict[str, Any] = {}
        for name, dom in param_space.items():
            if isinstance(dom, dict) and "grid_search" in dom:
                raise ValueError(
                    "OptunaSearch does not expand grid_search axes; "
                    "use BasicVariantGenerator"
                )
            converted = self._convert(dom)
            if converted is None:
                self._constants[name] = dom
            else:
                self._distributions[name] = converted
        direction = "minimize" if mode == "min" else "maximize"
        if self.using_fake:
            self._study = self._optuna.create_study(
                direction=direction, seed=seed
            )
        else:
            sampler = self._optuna.samplers.TPESampler(seed=seed)
            self._study = self._optuna.create_study(
                direction=direction, sampler=sampler
            )
        self._ongoing: dict[str, Any] = {}  # tune trial_id → optuna trial

    def _convert(self, dom):
        o = self._optuna
        if isinstance(dom, Uniform):
            return o.FloatDistribution(dom.low, dom.high)
        if isinstance(dom, LogUniform):
            return o.FloatDistribution(dom.low, dom.high, log=True)
        if isinstance(dom, RandInt):
            # Our randint is exclusive-high; optuna's is inclusive.
            return o.IntDistribution(dom.low, dom.high - 1)
        if isinstance(dom, Choice):
            return o.CategoricalDistribution(dom.categories)
        if isinstance(dom, Domain):
            raise ValueError(
                f"cannot convert {type(dom).__name__} to an optuna "
                "distribution"
            )
        return None  # constant

    def suggest(self, trial_id: str) -> dict | None:
        trial = self._study.ask(self._distributions)
        self._ongoing[trial_id] = trial
        return {**self._constants, **trial.params}

    def on_trial_complete(self, trial_id: str, result: dict | None):
        trial = self._ongoing.pop(trial_id, None)
        if trial is None:
            return
        if result is None or self.metric not in result:
            # Every asked trial must reach a terminal state, or real
            # optuna accumulates RUNNING phantoms across a long sweep.
            if not self.using_fake:
                self._study.tell(
                    trial, state=self._optuna.trial.TrialState.FAIL
                )
            return
        self._study.tell(trial, float(result[self.metric]))

    @property
    def best_params(self) -> dict | None:
        try:
            best = self._study.best_trial
        except ValueError:
            # Real optuna raises when no trial has completed yet.
            return None
        return None if best is None else {**self._constants, **best.params}
