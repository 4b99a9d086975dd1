"""BOHB search: Bayesian-optimized HyperBand suggestions (Falkner,
Klein & Hutter 2018) over the Tune Searcher seam.

Reference adapter: python/ray/tune/search/bohb/bohb_search.py:1
(TuneBOHB) wraps hpbandster's BOHB config generator and pairs with the
HyperBandForBOHB scheduler. hpbandster is not in this image (and is
unmaintained), so the KDE machinery is implemented natively here —
the same mechanics the paper and hpbandster use:

- Observations are bucketed by BUDGET (the ``time_attr`` value a trial
  reached before completing or being stopped by the scheduler —
  pairing with :class:`ray_tpu_torch.tune.schedulers.ASHAScheduler` gives
  the successive-halving budget ladder).
- The model uses the HIGHEST budget with at least
  ``min_points_in_model`` observations; the good/bad split is at the
  top ``gamma`` quantile.
- A suggestion draws ``num_candidates`` samples around good
  observations (diagonal Gaussian KDE, log-space for log domains) and
  keeps the one maximizing l(x)/g(x); with probability
  ``random_fraction`` (and before the model has data) it samples the
  prior instead — BOHB's guaranteed-exploration floor.
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


class BOHBSearch(Searcher):
    """Model-based suggestions with multi-fidelity observation buckets.

    param_space uses this package's Domain objects (uniform,
    loguniform, randint, choice) or plain constants; grid_search axes
    are not supported (use BasicVariantGenerator), matching the
    reference adapter.
    """

    def __init__(
        self,
        param_space: dict,
        *,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        min_points_in_model: int | None = None,
        gamma: float = 0.25,
        num_candidates: int = 24,
        random_fraction: float = 1 / 3,
        bandwidth_factor: float = 3.0,
        seed=None,
    ):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.gamma = gamma
        self.num_candidates = num_candidates
        self.random_fraction = random_fraction
        self.bandwidth_factor = bandwidth_factor
        self._rng = random.Random(seed)
        self._constants: dict[str, Any] = {}
        self._domains: dict[str, Domain] = {}
        for name, dom in param_space.items():
            if isinstance(dom, dict) and "grid_search" in dom:
                raise ValueError(
                    "BOHBSearch does not expand grid_search axes; use "
                    "BasicVariantGenerator"
                )
            if isinstance(dom, Domain):
                self._domains[name] = dom
            else:
                self._constants[name] = dom
        self.min_points_in_model = (
            max(len(self._domains) + 1, 3)
            if min_points_in_model is None
            else min_points_in_model
        )
        # budget → list[(params, objective)], objective minimized.
        self._by_budget: dict[float, list[tuple[dict, float]]] = {}
        self._ongoing: dict[str, dict] = {}

    # ------------------------------------------------------- sampling
    def _sample_prior(self) -> dict:
        return {
            name: dom.sample(self._rng)
            for name, dom in self._domains.items()
        }

    def _model_budget(self) -> float | None:
        """Highest budget with enough observations (BOHB's rule: the
        most informative fidelity that can support a model)."""
        eligible = [
            b
            for b, obs in self._by_budget.items()
            if len(obs) >= self.min_points_in_model
        ]
        return max(eligible) if eligible else None

    def _split(self, obs: list) -> tuple[list, list]:
        ordered = sorted(obs, key=lambda pv: pv[1])
        n_good = max(self.min_points_in_model - 1,
                     int(math.ceil(self.gamma * len(ordered))))
        n_good = min(n_good, len(ordered) - 1) or 1
        return ordered[:n_good], ordered[n_good:]

    def _bandwidth(self, dom, values: list) -> float:
        lo, hi = self._bounds(dom)
        spread = (hi - lo) or 1.0
        if len(values) > 1:
            mean = sum(values) / len(values)
            var = sum((v - mean) ** 2 for v in values) / (
                len(values) - 1
            )
            sigma = math.sqrt(var)
        else:
            sigma = 0.0
        return max(sigma, spread / 20.0)

    def _bounds(self, dom) -> tuple[float, float]:
        if isinstance(dom, LogUniform):
            return math.log(dom.low), math.log(dom.high)
        if isinstance(dom, (Uniform, RandInt)):
            return float(dom.low), float(dom.high)
        return 0.0, 1.0

    def _to_cont(self, dom, v) -> float:
        return math.log(v) if isinstance(dom, LogUniform) else float(v)

    def _from_cont(self, dom, x: float):
        if isinstance(dom, LogUniform):
            return min(dom.high, max(dom.low, math.exp(x)))
        if isinstance(dom, RandInt):
            return int(min(dom.high, max(dom.low, round(x))))
        if isinstance(dom, Uniform):
            return min(dom.high, max(dom.low, x))
        return x

    def _kde_logpdf(self, dom, x: float, values: list, bw: float) -> float:
        if not values:
            return 0.0
        acc = 0.0
        for v in values:
            acc += math.exp(-0.5 * ((x - v) / bw) ** 2)
        return math.log(acc / (len(values) * bw) + 1e-300)

    def _choice_logpmf(self, choices, v, values: list) -> float:
        # Add-one-smoothed categorical frequency.
        count = sum(1 for o in values if o == v)
        return math.log((count + 1) / (len(values) + len(choices)))

    def _sample_model(self, obs: list) -> dict:
        good, bad = self._split(obs)
        # Candidate-independent projections and bandwidths, hoisted out
        # of the num_candidates loop (they scale with observation
        # count; recomputing 24x per suggest is pure waste).
        per_dom: dict[str, tuple] = {}
        for name, dom in self._domains.items():
            if isinstance(dom, Choice):
                per_dom[name] = (
                    [p[name] for p, _ in good],
                    [p[name] for p, _ in bad],
                    None,
                    None,
                )
            else:
                gvals = [self._to_cont(dom, p[name]) for p, _ in good]
                bvals = [self._to_cont(dom, p[name]) for p, _ in bad]
                per_dom[name] = (
                    gvals,
                    bvals,
                    self._bandwidth(dom, gvals),
                    self._bandwidth(dom, bvals),
                )
        best_params, best_score = None, -math.inf
        for _ in range(self.num_candidates):
            seed_params, _ = self._rng.choice(good)
            cand: dict = {}
            score = 0.0
            for name, dom in self._domains.items():
                gvals, bvals, bw_g, bw_b = per_dom[name]
                if isinstance(dom, Choice):
                    v = self._rng.choice(
                        gvals if self._rng.random() < 0.8
                        else list(dom.categories)
                    )
                    cand[name] = v
                    score += self._choice_logpmf(
                        dom.categories, v, gvals
                    ) - self._choice_logpmf(dom.categories, v, bvals)
                    continue
                center = self._to_cont(dom, seed_params[name])
                x = self._rng.gauss(
                    center, bw_g * self.bandwidth_factor
                )
                cand[name] = self._from_cont(dom, x)
                x = self._to_cont(dom, cand[name])
                score += self._kde_logpdf(
                    dom, x, gvals, bw_g
                ) - self._kde_logpdf(dom, x, bvals, bw_b)
            if score > best_score:
                best_params, best_score = cand, score
        return best_params or self._sample_prior()

    # ---------------------------------------------------- Searcher API
    def suggest(self, trial_id: str) -> dict | None:
        budget = self._model_budget()
        if budget is None or self._rng.random() < self.random_fraction:
            params = self._sample_prior()
        else:
            params = self._sample_model(self._by_budget[budget])
        config = {**self._constants, **params}
        self._ongoing[trial_id] = params
        return config

    def on_trial_complete(self, trial_id: str, result: dict | None):
        params = self._ongoing.pop(trial_id, None)
        if params is None or not result or self.metric not in result:
            return
        value = float(result[self.metric])
        if self.mode == "max":
            value = -value
        budget = float(result.get(self.time_attr, 1))
        self._by_budget.setdefault(budget, []).append((params, value))
