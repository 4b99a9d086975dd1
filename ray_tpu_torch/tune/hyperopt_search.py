"""HyperOptSearch: drive Tune trials from hyperopt's TPE.

Mirrors the reference adapter (reference:
python/ray/tune/search/hyperopt/hyperopt_search.py:1 HyperOptSearch —
convert the Tune space to hp.* expressions, drive tpe.suggest against a
hyperopt Trials book manually, attach losses on completion) over this
package's Searcher seam. When hyperopt is not installed, the adapter
runs on the same in-module fake study engine OptunaSearch uses
(optuna_search._FakeStudy — ask/tell with TPE-flavored sampling), so
the space conversion and trial bookkeeping are exercised either way.

hp.choice indices: hyperopt reports categorical picks as INDICES into
the choice list; this adapter maps them back to the category values,
like the reference does.
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.tune.optuna_search import (
    _CategoricalDistribution,
    _FakeStudy,
    _FloatDistribution,
    _IntDistribution,
)
from ray_tpu_torch.tune.search import (
    Choice,
    Domain,
    LogUniform,
    RandInt,
    Searcher,
    Uniform,
)


def _load_hyperopt(force_fake: bool):
    if force_fake:
        return None, True
    try:
        import hyperopt  # noqa: PLC0415

        return hyperopt, False
    except ImportError:
        return None, True


class HyperOptSearch(Searcher):
    """Suggest Tune configs from hyperopt TPE (or the fake engine).

    param_space uses this package's Domain objects or constants;
    grid_search axes are rejected like the reference adapter.
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
        self._hp, self.using_fake = _load_hyperopt(_force_fake)
        self.metric = metric
        self.mode = mode
        self._seed = seed
        self._constants: dict[str, Any] = {}
        self._domains: dict[str, Domain] = {}
        for name, dom in param_space.items():
            if isinstance(dom, dict) and "grid_search" in dom:
                raise ValueError(
                    "HyperOptSearch does not expand grid_search axes; "
                    "use BasicVariantGenerator"
                )
            if isinstance(dom, Domain):
                self._domains[name] = dom
            else:
                self._constants[name] = dom
        self._ongoing: dict[str, Any] = {}  # tune trial_id → book entry
        if self.using_fake:
            self._study = _FakeStudy(
                "minimize" if mode == "min" else "maximize", seed=seed
            )
            self._fake_dists = {
                name: self._fake_dist(dom)
                for name, dom in self._domains.items()
            }
        else:
            self._space = {
                name: self._hp_expr(name, dom)
                for name, dom in self._domains.items()
            }
            self._trials = self._hp.Trials()
            self._hp_domain = self._hp.base.Domain(
                lambda spec: 0, self._space
            )
            # An unseeded searcher must explore differently per run
            # (the fake path's random.Random(None) already does).
            import random as _random

            self._next_seed = (
                seed if seed is not None else _random.randrange(1 << 30)
            )

    # ------------------------------------------------------ conversion
    @staticmethod
    def _fake_dist(dom: Domain):
        if isinstance(dom, Uniform):
            return _FloatDistribution(dom.low, dom.high)
        if isinstance(dom, LogUniform):
            return _FloatDistribution(dom.low, dom.high, log=True)
        if isinstance(dom, RandInt):
            return _IntDistribution(dom.low, dom.high - 1)
        if isinstance(dom, Choice):
            return _CategoricalDistribution(dom.categories)
        raise ValueError(
            f"cannot convert {type(dom).__name__} for hyperopt"
        )

    def _hp_expr(self, name: str, dom: Domain):
        import math

        hp = self._hp.hp
        if isinstance(dom, Uniform):
            return hp.uniform(name, dom.low, dom.high)
        if isinstance(dom, LogUniform):
            return hp.loguniform(name, math.log(dom.low), math.log(dom.high))
        if isinstance(dom, RandInt):
            return dom.low + hp.randint(name, dom.high - dom.low)
        if isinstance(dom, Choice):
            return hp.choice(name, dom.categories)
        raise ValueError(
            f"cannot convert {type(dom).__name__} to an hp expression"
        )

    # -------------------------------------------------------- protocol
    def suggest(self, trial_id: str) -> dict | None:
        if self.using_fake:
            trial = self._study.ask(self._fake_dists)
            self._ongoing[trial_id] = trial
            return {**self._constants, **trial.params}

        new_ids = self._trials.new_trial_ids(1)
        self._next_seed += 1
        docs = self._hp.tpe.suggest(
            new_ids, self._hp_domain, self._trials, self._next_seed
        )
        self._trials.insert_trial_docs(docs)
        self._trials.refresh()
        doc = docs[0]
        # Keep the doc itself: completion marks it in place (O(1), no
        # linear scan of the trials book).
        self._ongoing[trial_id] = doc
        return {**self._constants, **self._params_from_vals(doc)}

    def _params_from_vals(self, doc) -> dict:
        """misc.vals carries hyperopt's RAW labels: choice picks are
        indices into the category list, randint values are 0-based
        regardless of the dom.low offset applied in the expression —
        both must be decoded back to user-space values."""
        vals = {k: v[0] for k, v in doc["misc"]["vals"].items() if v}
        params = {}
        for name, dom in self._domains.items():
            v = vals[name]
            if isinstance(dom, Choice):
                v = dom.categories[int(v)]
            elif isinstance(dom, RandInt):
                v = int(v) + dom.low
            params[name] = v
        return params

    def on_trial_complete(self, trial_id: str, result: dict | None):
        entry = self._ongoing.pop(trial_id, None)
        if entry is None:
            return
        failed = result is None or self.metric not in result
        if self.using_fake:
            if not failed:
                self._study.tell(entry, float(result[self.metric]))
            return
        value = None if failed else float(result[self.metric])
        if value is not None and self.mode == "max":
            value = -value  # hyperopt minimizes
        doc = entry
        if failed:
            doc["state"] = self._hp.JOB_STATE_ERROR
            doc["result"] = {"status": self._hp.STATUS_FAIL}
        else:
            doc["state"] = self._hp.JOB_STATE_DONE
            doc["result"] = {
                "loss": value,
                "status": self._hp.STATUS_OK,
            }
        self._trials.refresh()

    @property
    def best_params(self) -> dict | None:
        if self.using_fake:
            best = self._study.best_trial
            return (
                None
                if best is None
                else {**self._constants, **best.params}
            )
        done = [
            t
            for t in self._trials.trials
            if t["state"] == self._hp.JOB_STATE_DONE
        ]
        if not done:
            return None
        best = min(done, key=lambda t: t["result"]["loss"])
        return {**self._constants, **self._params_from_vals(best)}
