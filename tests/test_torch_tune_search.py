"""The port's Tune searchers (ray_tpu_torch/tune/search.py,
optuna_search.py, hyperopt_search.py, bohb_search.py) against the JAX
package's.

- Parity: each searcher of both packages gets the same search space, the
  same seed and the same reported results, round after round, and must
  suggest the identical config every round (25 rounds): grid and random
  ``BasicVariantGenerator``, ``TPESearcher``, ``OptunaSearch``,
  ``HyperOptSearch`` and ``BOHBSearch`` (the native TPE and BOHB paths:
  neither needs an outside package), with ``ConcurrencyLimiter`` and
  ``Repeater`` around a TPE searcher.
- tests/test_searchers.py's cases on the port, the Tuner runs on the
  port's runtime.
"""

from __future__ import annotations

import math
import random

import pytest

from ray_tpu_torch.tune.search import (
    DEFER,
    ConcurrencyLimiter,
    Repeater,
    Searcher,
    TPESearcher,
    choice,
    uniform,
)
from torch_runtime_util import start_cluster, stop_cluster

ROUNDS = 25


def _space(s):
    """A space over every Domain type, plus a constant."""
    return {
        "x": s.uniform(0, 1),
        "lr": s.loguniform(1e-4, 1e-1),
        "layers": s.randint(1, 8),
        "opt": s.choice(["sgd", "adam", "rmsprop"]),
        "fixed": "const",
    }


def _objective(cfg):
    return ((cfg["x"] - 0.7) ** 2
            + (math.log10(cfg["lr"]) + 2) ** 2 * 0.1
            + 0.01 * cfg["layers"]
            + (0.0 if cfg["opt"] == "adam" else 0.5))


def _grid(pkg):
    s = pkg.search
    return s.BasicVariantGenerator(
        {"a": s.grid_search([1, 2, 3]), "b": s.grid_search(["p", "q"]),
         "x": s.uniform(0, 1), "fixed": "const"},
        num_samples=5, seed=3)


def _random(pkg):
    return pkg.search.BasicVariantGenerator(_space(pkg.search),
                                            num_samples=ROUNDS, seed=11)


def _tpe(pkg):
    return pkg.search.TPESearcher(_space(pkg.search), metric="loss",
                                  mode="min", n_initial=6, seed=0)


def _optuna(pkg):
    return pkg.optuna_search.OptunaSearch(_space(pkg.search), metric="loss",
                                          mode="min", seed=0,
                                          _force_fake=True)


def _hyperopt(pkg):
    return pkg.hyperopt_search.HyperOptSearch(
        _space(pkg.search), metric="loss", mode="min", seed=1,
        _force_fake=True)


def _bohb(pkg):
    return pkg.bohb_search.BOHBSearch(_space(pkg.search), metric="loss",
                                      mode="min", seed=2)


def _limited(pkg):
    return pkg.search.ConcurrencyLimiter(_tpe(pkg), max_concurrent=2)


def _repeated(pkg):
    return pkg.search.Repeater(_tpe(pkg), repeat=3, metric="loss")


def _packages():
    import ray_tpu.tune as jtune
    import ray_tpu.tune.bohb_search
    import ray_tpu.tune.hyperopt_search
    import ray_tpu.tune.optuna_search  # noqa: F401

    import ray_tpu_torch.tune as ttune
    import ray_tpu_torch.tune.bohb_search
    import ray_tpu_torch.tune.hyperopt_search
    import ray_tpu_torch.tune.optuna_search  # noqa: F401

    return jtune, ttune


@pytest.mark.parametrize("make", [_grid, _random, _tpe, _optuna, _hyperopt,
                                  _bohb, _limited, _repeated],
                         ids=lambda f: f.__name__.strip("_"))
def test_suggestions_equal_the_reference(make):
    """Suggest, report, repeat: both packages' searchers walk the same
    configs. A limiter's DEFER must fall on the same rounds, and a
    finished generator must end on the same round."""
    jtune, ttune = _packages()
    want_s, got_s = make(jtune), make(ttune)
    rounds = 0
    for i in range(ROUNDS):
        tid = f"t{i}"
        want, got = want_s.suggest(tid), got_s.suggest(tid)
        if want is jtune.search.DEFER:
            assert got is DEFER, (i, got)
        else:
            assert got == want, (i, got, want)
        if want is None:
            break
        rounds += 1
        if want is not jtune.search.DEFER:
            result = {"loss": _objective({**{"lr": 1e-2, "layers": 1,
                                             "opt": "adam"}, **want}),
                      "training_iteration": 1 + i % 4}
            want_s.on_trial_complete(tid, dict(result))
            got_s.on_trial_complete(tid, dict(result))
    assert rounds == ROUNDS


# ------------------------------------ tests/test_searchers.py on the port
def _drive(searcher, objective, n):
    """suggest/complete loop; returns all (config, value)."""
    out = []
    for i in range(n):
        tid = f"t{i}"
        cfg = searcher.suggest(tid)
        assert cfg is not None and cfg is not DEFER
        val = objective(cfg)
        searcher.on_trial_complete(tid, {"loss": val})
        out.append((cfg, val))
    return out


def test_tpe_beats_random_on_quadratic():
    def objective(cfg):
        return (cfg["x"] - 0.7) ** 2 + (cfg["y"] - 0.2) ** 2

    tpe = TPESearcher(
        {"x": uniform(0, 1), "y": uniform(0, 1)},
        metric="loss", mode="min", n_initial=8, seed=0,
    )
    tpe_hist = _drive(tpe, objective, 60)
    rng = random.Random(0)
    random_hist = [
        {"x": rng.uniform(0, 1), "y": rng.uniform(0, 1)} for _ in range(60)
    ]
    best_tpe = min(v for _c, v in tpe_hist)
    best_rand = min(objective(c) for c in random_hist)
    assert best_tpe <= best_rand * 1.5
    late = [c for c, _v in tpe_hist[-15:]]
    near = sum(1 for c in late if abs(c["x"] - 0.7) < 0.25)
    assert near >= 8


def test_tpe_handles_choice_and_fixed_params():
    def objective(cfg):
        assert cfg["fixed"] == "const"
        return 0.0 if cfg["opt"] == "adam" else 1.0

    tpe = TPESearcher(
        {"opt": choice(["sgd", "adam", "rmsprop"]), "fixed": "const"},
        metric="loss", mode="min", n_initial=6, seed=1,
    )
    hist = _drive(tpe, objective, 40)
    late = [c["opt"] for c, _v in hist[-10:]]
    assert late.count("adam") >= 6


class _CountingSearcher(Searcher):
    def __init__(self):
        self.n = 0
        self.completed = []

    def suggest(self, trial_id):
        self.n += 1
        return {"i": self.n}

    def on_trial_complete(self, trial_id, result):
        self.completed.append((trial_id, result))


def test_concurrency_limiter_defers():
    limiter = ConcurrencyLimiter(_CountingSearcher(), max_concurrent=2)
    a = limiter.suggest("a")
    b = limiter.suggest("b")
    assert a and b
    assert limiter.suggest("c") is DEFER
    limiter.on_trial_complete("a", {"loss": 1})
    assert limiter.suggest("c") is not DEFER


def test_repeater_averages_before_reporting():
    inner = _CountingSearcher()
    rep = Repeater(inner, repeat=3, metric="loss")
    cfgs = [rep.suggest(f"t{i}") for i in range(3)]
    assert cfgs[0] == cfgs[1] == cfgs[2]
    rep.on_trial_complete("t0", {"loss": 1.0})
    rep.on_trial_complete("t1", {"loss": 2.0})
    assert not inner.completed
    rep.on_trial_complete("t2", {"loss": 3.0})
    assert len(inner.completed) == 1
    assert inner.completed[0][1]["loss"] == pytest.approx(2.0)


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=2)
    yield info
    stop_cluster(info)


def _tuner_best(search_alg, scheduler=None, num_samples=12, steps=1):
    from ray_tpu_torch import tune

    def objective(config):
        for it in range(steps):
            tune.report({"loss": (config["lr"] - 0.3) ** 2
                         + (0.1 / (it + 1) if steps > 1 else 0.0)})

    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.uniform(0.0, 1.0)},
        tune_config=tune.TuneConfig(
            num_samples=num_samples, max_concurrent_trials=2,
            metric="loss", mode="min", search_alg=search_alg,
            scheduler=scheduler),
    ).fit()
    assert len(grid) == num_samples
    return grid.get_best_result(metric="loss", mode="min").metrics["loss"]


def test_tpe_end_to_end_with_tuner(cluster):
    from ray_tpu_torch import tune

    best = _tuner_best(tune.TPESearcher({"lr": tune.uniform(0.0, 1.0)},
                                        metric="loss", mode="min",
                                        n_initial=4, seed=0))
    assert best < 0.2


def test_optuna_search_converts_space_and_optimizes():
    from ray_tpu_torch.tune.optuna_search import OptunaSearch
    from ray_tpu_torch.tune.search import loguniform, randint

    def objective(cfg):
        assert cfg["fixed"] == "const"
        assert 1e-4 <= cfg["lr"] <= 1e-1
        assert 1 <= cfg["layers"] < 8
        return (cfg["x"] - 0.7) ** 2 + (0.0 if cfg["opt"] == "adam" else 0.5)

    s = OptunaSearch(
        {"x": uniform(0, 1), "lr": loguniform(1e-4, 1e-1),
         "layers": randint(1, 8), "opt": choice(["sgd", "adam"]),
         "fixed": "const"},
        metric="loss", mode="min", seed=0,
    )
    hist = _drive(s, objective, 60)
    assert min(v for _c, v in hist) < 0.05
    late = [c for c, _v in hist[-15:]]
    assert sum(1 for c in late if c["opt"] == "adam") >= 8
    assert s.best_params is not None and "x" in s.best_params


def test_optuna_search_rejects_grid_axes():
    from ray_tpu_torch.tune.optuna_search import OptunaSearch
    from ray_tpu_torch.tune.search import grid_search

    with pytest.raises(ValueError):
        OptunaSearch({"x": grid_search([1, 2])})


def test_optuna_search_maximize_direction():
    from ray_tpu_torch.tune.optuna_search import OptunaSearch

    s = OptunaSearch({"x": uniform(0, 1)}, metric="acc", mode="max", seed=3)
    hist = []
    for i in range(50):
        cfg = s.suggest(f"t{i}")
        acc = 1 - (cfg["x"] - 0.2) ** 2
        s.on_trial_complete(f"t{i}", {"acc": acc})
        hist.append((cfg, acc))
    late = [c["x"] for c, _v in hist[-15:]]
    assert sum(1 for x in late if abs(x - 0.2) < 0.3) >= 8
    assert abs(s.best_params["x"] - 0.2) < 0.3


def test_optuna_end_to_end_with_tuner(cluster):
    from ray_tpu_torch import tune

    best = _tuner_best(tune.OptunaSearch({"lr": tune.uniform(0.0, 1.0)},
                                         metric="loss", mode="min", seed=0))
    assert best < 0.25


def test_hyperopt_search_converts_space_and_optimizes():
    from ray_tpu_torch.tune.hyperopt_search import HyperOptSearch
    from ray_tpu_torch.tune.search import loguniform, randint

    def objective(cfg):
        assert cfg["fixed"] == "const"
        assert 1e-4 <= cfg["lr"] <= 1e-1
        assert 1 <= cfg["layers"] < 8
        return (cfg["x"] - 0.7) ** 2 + (0.0 if cfg["opt"] == "adam" else 0.5)

    s = HyperOptSearch(
        {"x": uniform(0, 1), "lr": loguniform(1e-4, 1e-1),
         "layers": randint(1, 8), "opt": choice(["sgd", "adam"]),
         "fixed": "const"},
        metric="loss", mode="min", seed=0,
    )
    hist = _drive(s, objective, 60)
    assert min(v for _c, v in hist) < 0.05
    late = [c for c, _v in hist[-15:]]
    assert sum(1 for c in late if c["opt"] == "adam") >= 8
    assert s.best_params is not None and "x" in s.best_params


def test_hyperopt_search_rejects_grid_axes():
    from ray_tpu_torch.tune.hyperopt_search import HyperOptSearch
    from ray_tpu_torch.tune.search import grid_search

    with pytest.raises(ValueError):
        HyperOptSearch({"x": grid_search([1, 2])})


def test_hyperopt_end_to_end_with_tuner(cluster):
    from ray_tpu_torch import tune

    best = _tuner_best(tune.HyperOptSearch({"lr": tune.uniform(0.0, 1.0)},
                                           metric="loss", mode="min",
                                           seed=0))
    assert best < 0.3


def test_bohb_search_optimizes_and_uses_model():
    from ray_tpu_torch.tune.bohb_search import BOHBSearch
    from ray_tpu_torch.tune.search import loguniform, randint

    def objective(cfg):
        assert cfg["fixed"] == "const"
        return ((cfg["x"] - 0.7) ** 2
                + (math.log10(cfg["lr"]) + 2) ** 2 * 0.1
                + (0.0 if cfg["opt"] == "adam" else 0.5))

    s = BOHBSearch(
        {"x": uniform(0, 1), "lr": loguniform(1e-4, 1e-1),
         "layers": randint(1, 8), "opt": choice(["sgd", "adam"]),
         "fixed": "const"},
        metric="loss", mode="min", seed=0,
    )
    hist = []
    for i in range(80):
        cfg = s.suggest(f"t{i}")
        v = objective(cfg)
        s.on_trial_complete(f"t{i}", {"loss": v, "training_iteration": 4})
        hist.append((cfg, v))
    assert min(v for _c, v in hist) < 0.05
    late = [c for c, _v in hist[-20:]]
    assert sum(1 for c in late if c["opt"] == "adam") >= 12


def test_bohb_models_highest_informative_budget():
    from ray_tpu_torch.tune.bohb_search import BOHBSearch

    s = BOHBSearch({"x": uniform(0, 1)}, metric="loss", mode="min", seed=1,
                   random_fraction=0.1)
    for i in range(20):
        cfg = s.suggest(f"lo{i}")
        s.on_trial_complete(f"lo{i}", {"loss": cfg["x"],
                                       "training_iteration": 1})
    for i in range(20):
        cfg = s.suggest(f"hi{i}")
        s.on_trial_complete(f"hi{i}", {"loss": (cfg["x"] - 0.9) ** 2,
                                       "training_iteration": 8})
    assert s._model_budget() == 8.0
    xs = [s.suggest(f"probe{i}")["x"] for i in range(30)]
    near_true = sum(1 for x in xs if abs(x - 0.9) < 0.25)
    near_misleading = sum(1 for x in xs if x < 0.25)
    assert near_true > near_misleading, xs


def test_bohb_rejects_grid_axes_and_pairs_with_asha(cluster):
    from ray_tpu_torch import tune
    from ray_tpu_torch.tune.bohb_search import BOHBSearch
    from ray_tpu_torch.tune.search import grid_search

    with pytest.raises(ValueError):
        BOHBSearch({"x": grid_search([1, 2])})
    best = _tuner_best(
        tune.BOHBSearch({"lr": tune.uniform(0.0, 1.0)}, metric="loss",
                        mode="min", seed=0),
        scheduler=tune.ASHAScheduler(metric="loss", mode="min", max_t=8,
                                     grace_period=1, reduction_factor=2),
        num_samples=16, steps=8)
    assert best < 0.3
