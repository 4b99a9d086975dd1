"""The port's Tune schedulers (ray_tpu_torch/tune/schedulers.py) against
the JAX package's: the same result stream goes through both packages'
``FIFOScheduler``, ``ASHAScheduler``, ``HyperBandScheduler``,
``MedianStoppingRule``, ``PopulationBasedTraining``, ``LedgerASHA`` and
``LedgerPBT``, and every decision, exploit source, exploit pair and
perturbed config must be identical. Then tests/test_tune_sweep.py's two
ledger-scheduler cases on the port.

The stream: 8 trials with seeded noisy learning curves, reported in
lockstep ticks (the Tuner's batch path) or one result at a time (its
per-result path); a trial leaves the stream when it is stopped, and an
exploited trial continues from its source's last value.
"""

from __future__ import annotations

import numpy as np
import pytest

N_TRIALS, TICKS = 8, 16


class _Trial:
    """The part of tune/trial.py's Trial a scheduler reads."""

    def __init__(self, trial_id, config):
        self.trial_id = trial_id
        self.config = dict(config)


def _curves(seed, mode):
    """[trial, tick] metric values: noisy curves that improve at trial-
    dependent rates, in the scheduler's mode."""
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.05, 0.6, N_TRIALS)[:, None]
    t = np.arange(1, TICKS + 1)[None, :]
    v = 1.0 / (1.0 + rate * t) + 0.05 * rng.standard_normal((N_TRIALS,
                                                             TICKS))
    return (1.0 - v) if mode == "max" else v


def _schedulers(S, name):
    if name == "fifo":
        return S.FIFOScheduler(), "max"
    if name == "asha":
        return S.ASHAScheduler(metric="m", mode="min", grace_period=1,
                               reduction_factor=2, max_t=TICKS), "min"
    if name == "hyperband":
        return S.HyperBandScheduler(metric="m", mode="max", grace_period=1,
                                    reduction_factor=2, max_t=TICKS,
                                    num_brackets=3), "max"
    if name == "median":
        return S.MedianStoppingRule(metric="m", mode="min", grace_period=2,
                                    min_samples_required=3), "min"
    if name == "pbt":
        return S.PopulationBasedTraining(
            metric="m", mode="max", perturbation_interval=3,
            hyperparam_mutations={"lr": [1e-3, 1e-2, 1e-1],
                                  "wd": 1e-4},
            quantile_fraction=0.25, seed=5), "max"
    raise KeyError(name)


def _run(S, name, batched, seed):
    """Drive one package's scheduler over the stream; returns the log of
    every (tick, trial, decision[, source, config]) it produced."""
    sched, mode = _schedulers(S, name)
    curves = _curves(seed, mode)
    trials = [_Trial(f"t{i}", {"lr": 1e-3 * (i + 1), "wd": 1e-4})
              for i in range(N_TRIALS)]
    value = {t.trial_id: 0.0 for t in trials}
    offset = {t.trial_id: 0.0 for t in trials}
    live = list(trials)
    log = []
    for tick in range(TICKS):
        batch = []
        for i, tr in enumerate(trials):
            if tr not in live:
                continue
            v = float(curves[i, tick]) + offset[tr.trial_id]
            value[tr.trial_id] = v
            batch.append((tr, {"training_iteration": tick + 1, "m": v}))
        if batched:
            decisions = sched.on_batch(batch, live)
        else:
            decisions = {tr.trial_id: sched.on_result(tr, res, live)
                         for tr, res in batch}
        for tr, _ in batch:
            d = decisions[tr.trial_id]
            entry = [tick, tr.trial_id, d]
            if d == S.STOP:
                live.remove(tr)
            elif d == S.EXPLOIT:
                src = sched.choose_exploit_source(tr, live)
                entry.append(None if src is None else src.trial_id)
                if src is not None:
                    tr.config = sched.perturb(src.config)
                    offset[tr.trial_id] = value[src.trial_id] - value[
                        tr.trial_id]
                entry.append(dict(tr.config))
            log.append(entry)
    return log


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "each"])
@pytest.mark.parametrize("name", ["fifo", "asha", "hyperband", "median",
                                  "pbt"])
def test_trial_scheduler_decisions_equal_the_reference(name, batched):
    from ray_tpu.tune import schedulers as jS

    from ray_tpu_torch.tune import schedulers as tS

    for seed in range(3):
        want = _run(jS, name, batched, seed)
        got = _run(tS, name, batched, seed)
        assert got == want, (seed, [
            (g, w) for g, w in zip(got, want) if g != w][:3])
    if name != "fifo":
        # The stream exercises the scheduler: some trial is stopped or
        # exploited.
        assert any(e[2] != tS.CONTINUE for e in got)


def _ledger_rows(seed, n=6, polls=14):
    """Per poll, {trial_id: (steps, value)} as the sweep reads the
    ledger: steps advance by 0-2 between polls, the value is the latest
    loss (None before the first report)."""
    rng = np.random.default_rng(seed)
    rate = rng.uniform(0.05, 0.5, n)
    steps = np.zeros(n, dtype=int)
    out = []
    for _ in range(polls):
        steps += rng.integers(0, 3, n)
        out.append({f"t{i}": (int(s), None if s == 0 else float(
            1.0 / (1.0 + rate[i] * s) + 0.02 * rng.standard_normal()))
            for i, s in enumerate(steps)})
    return out


def test_ledger_asha_decisions_equal_the_reference():
    from ray_tpu.tune import schedulers as jS

    from ray_tpu_torch.tune import schedulers as tS

    stops = 0
    for seed in range(4):
        kw = dict(metric="loss", mode="min", grace_period=2,
                  reduction_factor=2, max_t=24)
        want_s, got_s = jS.LedgerASHA(**kw), tS.LedgerASHA(**kw)
        stopped = set()
        for rows in _ledger_rows(seed):
            for tid, (steps, v) in rows.items():
                if tid in stopped:
                    continue
                d = got_s.decide(tid, steps, v)
                assert d == want_s.decide(tid, steps, v), (seed, tid, steps)
                if d == tS.STOP:
                    stopped.add(tid)
        assert got_s._rungs == want_s._rungs
        stops += len(stopped)
    assert stops > 0


def test_ledger_pbt_pairs_and_perturbations_equal_the_reference():
    from ray_tpu.tune import schedulers as jS

    from ray_tpu_torch.tune import schedulers as tS

    pairs = 0
    for seed in range(4):
        kw = dict(metric="loss", mode="min", perturbation_interval=3,
                  hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3],
                                        "wd": 0.1},
                  quantile_fraction=0.34, seed=seed)
        want_s, got_s = jS.LedgerPBT(**kw), tS.LedgerPBT(**kw)
        configs = {f"t{i}": {"lr": 1e-4 * (i + 1), "wd": 0.1}
                   for i in range(6)}
        for rows in _ledger_rows(seed + 10):
            got, want = got_s.exploit_pairs(rows), want_s.exploit_pairs(rows)
            assert got == want, (seed, rows)
            for loser, winner in got:
                new = got_s.perturb(configs[winner])
                assert new == want_s.perturb(configs[winner])
                configs[loser] = new
                pairs += 1
    assert pairs > 0


# ---------------- tests/test_tune_sweep.py's ledger cases on the port
def test_ledger_asha_stops_bottom_of_rung():
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, LedgerASHA

    asha = LedgerASHA(metric="loss", mode="min", grace_period=2,
                      reduction_factor=2, max_t=100)
    assert asha.decide("a", 1, 0.9) == CONTINUE
    assert asha.decide("a", 2, 0.1) == CONTINUE
    assert asha.decide("b", 2, 0.9) == STOP
    assert asha.decide("c", 2, 0.05) == CONTINUE
    assert asha.decide("a", 3, 5.0) == CONTINUE
    assert asha.decide("a", 100, 0.0) == STOP


def test_ledger_pbt_exploit_pairs_and_perturb():
    from ray_tpu_torch.tune.schedulers import LedgerPBT

    pbt = LedgerPBT(metric="loss", mode="min", perturbation_interval=4,
                    hyperparam_mutations={"lr": [0.1, 0.2]},
                    quantile_fraction=0.25, seed=3)
    rows = {"w": (8, 0.1), "m1": (8, 0.5), "m2": (8, 0.6), "l": (8, 0.9)}
    assert pbt.exploit_pairs(rows) == [("l", "w")]
    assert pbt.exploit_pairs(rows) == []
    assert pbt.exploit_pairs({**rows, "l": (12, 0.9)}) == [("l", "w")]
    out = pbt.perturb({"lr": 0.5, "wd": 1e-4})
    assert out["lr"] in (0.1, 0.2) and out["wd"] == 1e-4
