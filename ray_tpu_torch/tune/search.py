"""Search spaces and suggestion algorithms.

Mirrors the reference's tune.search surface (reference:
python/ray/tune/search/ — sample.py distributions, grid_search,
BasicVariantGenerator basic_variant.py) in reduced form: distribution
objects + a variant generator that expands grid axes and samples the
rest; pluggable Searcher ABC for smarter algorithms.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Protocol, runtime_checkable


@runtime_checkable
class SearchAlgorithm(Protocol):
    """Structural contract every search backend speaks — the native
    Searcher subclasses here and the legacy wrappers (bohb_search /
    hyperopt_search / optuna_search) alike. ``suggest`` returns a
    config dict, ``None`` (exhausted), or the DEFER sentinel (ask again
    later); ``on_trial_complete`` feeds the observation back."""

    def suggest(self, trial_id: str) -> Any: ...

    def on_trial_complete(
        self, trial_id: str, result: dict | None
    ) -> None: ...


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.low, self.high = low, high
        self.lo, self.hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.lo, self.hi))


class RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def grid_search(values) -> dict:
    return {"grid_search": list(values)}


# Sentinel: "no suggestion right now, ask again later" — distinct from
# None ("search space exhausted"). Reference: ConcurrencyLimiter defers
# suggestions without finishing the search (tune/search/concurrency_limiter.py).
DEFER = object()


class Searcher:
    """ABC (reference: tune/search/searcher.py Searcher)."""

    def suggest(self, trial_id: str) -> dict | None:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: dict | None):
        pass


class BasicVariantGenerator(Searcher):
    """Expand grid_search axes into a cross product; sample Domain leaves
    num_samples times (reference: basic_variant.py semantics)."""

    def __init__(self, param_space: dict, num_samples: int = 1, seed=None):
        self.rng = random.Random(seed)
        grid_axes: list[tuple[str, list]] = []
        for k, v in param_space.items():
            if isinstance(v, dict) and set(v.keys()) == {"grid_search"}:
                grid_axes.append((k, v["grid_search"]))
        self.param_space = param_space
        if grid_axes:
            keys = [k for k, _ in grid_axes]
            combos = list(itertools.product(*[vals for _, vals in grid_axes]))
            self._grid = [dict(zip(keys, c)) for c in combos]
        else:
            self._grid = [{}]
        self._queue = [
            (g, s) for s in range(num_samples) for g in self._grid
        ]
        self._i = 0

    @property
    def total(self) -> int:
        return len(self._queue)

    def suggest(self, trial_id: str) -> dict | None:
        if self._i >= len(self._queue):
            return None
        grid_part, _ = self._queue[self._i]
        self._i += 1
        config = {}
        for k, v in self.param_space.items():
            if k in grid_part:
                config[k] = grid_part[k]
            elif isinstance(v, Domain):
                config[k] = v.sample(self.rng)
            elif isinstance(v, dict) and set(v.keys()) == {"grid_search"}:
                pass  # handled via grid_part
            else:
                config[k] = v
        config.update(grid_part)
        return config


class TPESearcher(Searcher):
    """Tree-structured-Parzen-Estimator-style Bayesian search over the
    Domain types (the native replacement for the reference's hyperopt /
    optuna integrations, tune/search/hyperopt, tune/search/optuna —
    both of which default to TPE samplers).

    After ``n_initial`` random trials, observations split into a good
    quantile (gamma) and the rest; candidates are sampled from a kernel
    density fit to the good configs and ranked by the density ratio
    l_good/l_bad, exactly TPE's acquisition.
    """

    def __init__(
        self,
        param_space: dict,
        metric: str,
        mode: str = "max",
        n_initial: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed=None,
    ):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.param_space = dict(param_space)
        # grid_search axes degrade to categorical choices under TPE.
        for k, v in self.param_space.items():
            if isinstance(v, dict) and set(v.keys()) == {"grid_search"}:
                self.param_space[k] = Choice(v["grid_search"])
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._configs: dict[str, dict] = {}  # trial_id → config
        self._history: list[tuple[dict, float]] = []  # (config, score)

    # -- observation model helpers ------------------------------------
    def _numeric_span(self, dom) -> tuple[float, float, bool]:
        """(low, high, log_scale) of a numeric domain."""
        import math

        if isinstance(dom, Uniform):
            return dom.low, dom.high, False
        if isinstance(dom, LogUniform):
            return math.exp(dom.lo), math.exp(dom.hi), True
        if isinstance(dom, RandInt):
            return float(dom.low), float(dom.high - 1), False
        raise TypeError(dom)

    def _kde_logpdf(self, dom, values: list, x: float) -> float:
        """Parzen estimate: mixture of gaussians at each observation."""
        import math

        low, high, logscale = self._numeric_span(dom)
        if logscale:
            low, high = math.log(low), math.log(high)
            x = math.log(max(x, 1e-300))
            values = [math.log(max(v, 1e-300)) for v in values]
        sigma = max((high - low), 1e-12) / max(math.sqrt(len(values)), 1.0)
        acc = 0.0
        for v in values:
            z = (x - v) / sigma
            acc += math.exp(-0.5 * z * z)
        return math.log(max(acc / (len(values) * sigma), 1e-300))

    def _sample_from(self, dom, values: list):
        """Draw near a random good observation (Parzen sampling)."""
        import math

        low, high, logscale = self._numeric_span(dom)
        if logscale:
            low, high = math.log(low), math.log(high)
            values = [math.log(max(v, 1e-300)) for v in values]
        sigma = max((high - low), 1e-12) / max(math.sqrt(len(values)), 1.0)
        center = self.rng.choice(values)
        x = min(max(self.rng.gauss(center, sigma), low), high)
        if logscale:
            x = math.exp(x)
        if isinstance(dom, RandInt):
            return int(round(min(max(x, dom.low), dom.high - 1)))
        return x

    # -- Searcher interface -------------------------------------------
    def suggest(self, trial_id: str) -> dict | None:
        import math

        tunable = {
            k: v for k, v in self.param_space.items()
            if isinstance(v, Domain)
        }
        config = {
            k: v for k, v in self.param_space.items()
            if not isinstance(v, Domain)
        }
        if len(self._history) < self.n_initial or not tunable:
            for k, dom in tunable.items():
                config[k] = dom.sample(self.rng)
            self._configs[trial_id] = config
            return config

        ranked = sorted(self._history, key=lambda t: -t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good = [c for c, _s in ranked[:n_good]]
        bad = [c for c, _s in ranked[n_good:]] or good

        best_cfg, best_score = None, None
        for _ in range(self.n_candidates):
            cand = dict(config)
            score = 0.0
            for k, dom in tunable.items():
                if isinstance(dom, Choice):
                    counts = {c: 1.0 for c in map(repr, dom.categories)}
                    for g in good:
                        counts[repr(g[k])] = counts.get(repr(g[k]), 1.0) + 1
                    total = sum(counts.values())
                    r = self.rng.uniform(0, total)
                    acc = 0.0
                    pick = dom.categories[-1]
                    for cat in dom.categories:
                        acc += counts[repr(cat)]
                        if r <= acc:
                            pick = cat
                            break
                    cand[k] = pick
                    bad_counts = {c: 1.0 for c in map(repr, dom.categories)}
                    for b in bad:
                        bad_counts[repr(b[k])] = (
                            bad_counts.get(repr(b[k]), 1.0) + 1
                        )
                    score += math.log(
                        counts[repr(pick)] / sum(counts.values())
                    ) - math.log(
                        bad_counts[repr(pick)] / sum(bad_counts.values())
                    )
                else:
                    x = self._sample_from(dom, [g[k] for g in good])
                    cand[k] = x
                    score += self._kde_logpdf(
                        dom, [g[k] for g in good], x
                    ) - self._kde_logpdf(dom, [b[k] for b in bad], x)
            if best_score is None or score > best_score:
                best_cfg, best_score = cand, score
        self._configs[trial_id] = best_cfg
        return best_cfg

    def on_trial_complete(self, trial_id: str, result: dict | None):
        config = self._configs.pop(trial_id, None)
        if config is None or result is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._history.append((config, score))


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (reference:
    tune/search/concurrency_limiter.py). Returns DEFER while the cap is
    reached so the controller retries later instead of finishing."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return DEFER
        config = self.searcher.suggest(trial_id)
        if config is not None and config is not DEFER:
            self._live.add(trial_id)
        return config

    def on_trial_complete(self, trial_id: str, result: dict | None):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class Repeater(Searcher):
    """Repeat each suggested config N times; once the group completes,
    report ONE result to the wrapped searcher, with ``metric`` (when
    given) averaged across repeats (reference: tune/search/repeater.py —
    de-noises stochastic objectives)."""

    def __init__(self, searcher: Searcher, repeat: int, metric: str | None = None):
        self.searcher = searcher
        self.repeat = max(1, repeat)
        self.metric = metric
        self._pending: list[tuple[str, dict]] = []  # queued repeats
        self._group_of: dict[str, str] = {}  # trial_id → group id
        self._results: dict[str, list] = {}  # group id → results

    def suggest(self, trial_id: str):
        if self._pending:
            group, config = self._pending.pop(0)
            self._group_of[trial_id] = group
            return dict(config)
        config = self.searcher.suggest(trial_id)
        if config is None or config is DEFER:
            return config
        group = trial_id
        self._group_of[trial_id] = group
        self._results[group] = []
        for _ in range(self.repeat - 1):
            self._pending.append((group, config))
        return config

    def on_trial_complete(self, trial_id: str, result: dict | None):
        group = self._group_of.pop(trial_id, None)
        if group is None:
            return
        bucket = self._results.get(group)
        if bucket is None:
            return
        bucket.append(result)
        if len(bucket) < self.repeat:
            return
        del self._results[group]
        ok = [r for r in bucket if r]
        if not ok:
            self.searcher.on_trial_complete(group, None)
            return
        merged = dict(ok[-1])
        if self.metric:
            # Only the declared metric is averaged; every other field
            # (iteration counters, timestamps) passes through untouched.
            vals = [r[self.metric] for r in ok if self.metric in r]
            if vals:
                merged[self.metric] = sum(vals) / len(vals)
        self.searcher.on_trial_complete(group, merged)
