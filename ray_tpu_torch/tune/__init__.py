"""ray_tpu_torch.tune: hyperparameter search over trial actors.

Capability-equivalent of the reference's Tune (reference:
python/ray/tune/ — Tuner.fit → TuneController event loop over trial
actors, searchers, schedulers, ResultGrid), reduced to the surfaces the
rest of this framework uses: function and class trainables, grid/random
search, ASHA / HyperBand / median-stopping / PBT schedulers, and
TPE / Optuna / HyperOpt / BOHB searchers.

The sweep engine (``Sweep``) layers gang scheduling on top: each trial
is a TorchTrainer worker gang admitted by the memory planner + cluster
GPU tables, early-stopped by ledger-driven schedulers (``LedgerASHA``),
and evolved by checkpoint-forked PBT (``LedgerPBT``).
"""

from __future__ import annotations

from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    HyperBandScheduler,
    FIFOScheduler,
    LedgerASHA,
    LedgerPBT,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.bohb_search import BOHBSearch
from ray_tpu_torch.tune.callbacks import (
    Callback,
    JsonLoggerCallback,
    MLflowLoggerCallback,
    WandbLoggerCallback,
)
from ray_tpu_torch.tune.hyperopt_search import HyperOptSearch
from ray_tpu_torch.tune.optuna_search import OptunaSearch
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Choice,
    ConcurrencyLimiter,
    Domain,
    Repeater,
    SearchAlgorithm,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.sweep import Sweep, SweepConfig, SweepResult
from ray_tpu_torch.tune.trial import StopTrial, Trainable, Trial
from ray_tpu_torch.tune.tuner import (
    ResultGrid,
    RunConfig,
    TrialResult,
    TuneConfig,
    Tuner,
)

# ---------------------------------------------------------------- session
_session = None


def _set_session(s):
    global _session
    _session = s


def report(metrics: dict, checkpoint: str | None = None) -> None:
    """Report metrics from inside a function trainable (reference:
    ray.tune.report / session.report)."""
    if _session is None:
        raise RuntimeError(
            "tune.report() is only valid inside a running trial"
        )
    _session.report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> str | None:
    """Checkpoint directory to restore from, if the trial was resumed
    (reference: ray.tune.get_checkpoint)."""
    if _session is None:
        raise RuntimeError(
            "tune.get_checkpoint() is only valid inside a running trial"
        )
    return _session.latest_checkpoint


__all__ = [
    "Tuner", "TuneConfig", "RunConfig", "ResultGrid", "TrialResult",
    "Trainable", "Trial", "StopTrial", "report", "get_checkpoint",
    "uniform", "loguniform", "randint", "choice", "grid_search",
    "TPESearcher", "OptunaSearch", "HyperOptSearch", "BOHBSearch",
    "ConcurrencyLimiter", "Repeater",
    "Domain", "Choice", "Searcher", "SearchAlgorithm",
    "BasicVariantGenerator",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining",
    "Sweep", "SweepConfig", "SweepResult", "LedgerASHA", "LedgerPBT",
    "Callback", "JsonLoggerCallback", "WandbLoggerCallback",
    "MLflowLoggerCallback",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu('tune')
del _rlu
