"""Connector pipelines: composable observation/batch transforms shared
across algorithms (reference: rllib/connectors/ — ConnectorV2 and
ConnectorPipelineV2, the reference's mechanism for reusing obs
preprocessing between algorithms; env_runner applies the env-to-module
pipeline each step, learners apply a batch pipeline before the update).

A connector is ``__call__(batch: dict, ctx: dict) -> dict`` plus
optional state (running statistics). Two phases:

- ``"step"``: applied inside the EnvRunner to ``{"obs": [N, D]}``
  before each forward pass — the transformed obs is ALSO what lands in
  the rollout buffer, so the learner trains on exactly the view the
  policy acted on.
- ``"batch"``: applied once to the completed rollout sample (reward
  clipping and friends).

Stateful connectors (``MeanStdObsFilter``) ship DELTAS — statistics
accumulated since their last report, cleared on reporting — back with
each sample; the driver absorbs every runner's deltas into one global
state and rebroadcasts it. Delta shipping is what makes the pooling
correct: absolute states share broadcast history, and pooling them
would re-count that history once per runner per round (the reference's
FilterManager.synchronize_filters clears filter buffers after each
report for exactly this reason, rllib/utils/filter_manager.py).
"""

from __future__ import annotations

import numpy as np


class Connector:
    phase = "step"  # "step" | "batch" | "both"

    @property
    def name(self) -> str:
        return type(self).__name__

    def __call__(self, batch: dict, ctx: dict) -> dict:
        raise NotImplementedError

    # -- optional running state (synced across runners) ----------------
    def get_state(self) -> dict:
        """Full-state snapshot (broadcast + checkpoints)."""
        return {}

    def set_state(self, state: dict) -> None:
        pass

    def report_delta(self) -> dict:
        """Runner side: statistics accumulated since the last report;
        CLEARS the delta buffer (empty dict = nothing to report)."""
        return {}

    def absorb_delta(self, delta: dict) -> None:
        """Driver side: fold one runner's reported delta into this
        (global) connector's state."""


class ConnectorPipeline(Connector):
    """Ordered connectors with the reference's mutation surface
    (append/prepend/insert_before/insert_after/remove)."""

    phase = "both"

    def __init__(self, *connectors: Connector):
        self.connectors = list(connectors)

    def __call__(self, batch: dict, ctx: dict) -> dict:
        phase = ctx.get("phase", "step")
        for c in self.connectors:
            if c.phase in (phase, "both"):
                batch = c(batch, ctx)
        return batch

    def _index_of(self, name: str) -> int:
        for i, c in enumerate(self.connectors):
            if c.name == name:
                return i
        raise KeyError(f"no connector named {name!r}")

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def insert_before(self, name: str, connector: Connector):
        self.connectors.insert(self._index_of(name), connector)
        return self

    def insert_after(self, name: str, connector: Connector):
        self.connectors.insert(self._index_of(name) + 1, connector)
        return self

    def remove(self, name: str) -> "ConnectorPipeline":
        self.connectors.pop(self._index_of(name))
        return self

    def _state_keys(self) -> "list[tuple[str, Connector]]":
        """(key, connector) pairs with keys unique per INSTANCE: the
        first occurrence of a class keeps its bare name, later ones get
        ``Name_1``, ``Name_2``… in pipeline order. Two ClipObs with
        different bounds therefore sync independently instead of one
        silently overwriting the other — valid as long as runner and
        driver pipelines are composed identically, which filter sync
        already requires."""
        seen: dict[str, int] = {}
        out = []
        for c in self.connectors:
            n = seen.get(c.name, 0)
            seen[c.name] = n + 1
            out.append((c.name if n == 0 else f"{c.name}_{n}", c))
        return out

    def get_state(self) -> dict:
        return {
            k: s for k, c in self._state_keys() if (s := c.get_state())
        }

    def set_state(self, state: dict) -> None:
        for k, c in self._state_keys():
            if k in state:
                c.set_state(state[k])

    def report_delta(self) -> dict:
        return {
            k: d for k, c in self._state_keys() if (d := c.report_delta())
        }

    def absorb_deltas(self, deltas: list[dict]) -> None:
        """Fold per-runner delta reports into this (driver) pipeline's
        global state, connector by connector."""
        for k, c in self._state_keys():
            for report in deltas:
                if k in report:
                    c.absorb_delta(report[k])


# ------------------------------------------------------------- builtins


class CastObs(Connector):
    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)

    def __call__(self, batch, ctx):
        batch["obs"] = np.asarray(batch["obs"], dtype=self.dtype)
        return batch


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, batch, ctx):
        batch["obs"] = np.clip(batch["obs"], self.low, self.high)
        return batch


class ClipReward(Connector):
    """Batch-phase reward clipping (reference: ClipRewards connector)."""

    phase = "batch"

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, batch, ctx):
        if "rewards" in batch:
            batch["rewards"] = np.clip(batch["rewards"], self.low, self.high)
        return batch


def _pool_moments(
    count_a, mean_a, m2_a, count_b, mean_b, m2_b
) -> tuple:
    """Chan et al. parallel pooling of two disjoint moment sets."""
    if count_b == 0:
        return count_a, mean_a, m2_a
    if count_a == 0:
        return count_b, mean_b.copy(), m2_b.copy()
    total = count_a + count_b
    d = mean_b - mean_a
    mean = mean_a + d * (count_b / total)
    m2 = m2_a + m2_b + d * d * (count_a * count_b / total)
    return total, mean, m2


class MeanStdObsFilter(Connector):
    """Running-mean/std observation normalization (reference:
    MeanStdFilter, rllib/connectors/env_to_module/mean_std_filter.py).

    Two moment sets: the WORKING stats (global broadcast + local
    unreported observations — what normalization uses) and the DELTA
    buffer (local observations since the last report). ``report_delta``
    ships and clears the buffer; the driver absorbs deltas from every
    runner into its own working stats and rebroadcasts, so each
    observation is pooled exactly once globally.
    """

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0.0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None
        self._d_count = 0.0
        self._d_mean: np.ndarray | None = None
        self._d_m2: np.ndarray | None = None

    def _ensure(self, dim: int):
        if self.mean is None:
            self.mean = np.zeros(dim)
            self.m2 = np.zeros(dim)
        if self._d_mean is None:
            self._d_mean = np.zeros(dim)
            self._d_m2 = np.zeros(dim)

    def __call__(self, batch, ctx):
        obs = np.asarray(batch["obs"], dtype=np.float64)
        self._ensure(obs.shape[-1])
        if ctx.get("update_stats", True):
            flat = obs.reshape(-1, obs.shape[-1])
            bcount = float(len(flat))
            bmean = flat.mean(0)
            bm2 = ((flat - bmean) ** 2).sum(0)
            self.count, self.mean, self.m2 = _pool_moments(
                self.count, self.mean, self.m2, bcount, bmean, bm2
            )
            self._d_count, self._d_mean, self._d_m2 = _pool_moments(
                self._d_count, self._d_mean, self._d_m2,
                bcount, bmean, bm2,
            )
        std = np.sqrt(self.m2 / max(1.0, self.count - 1)) + self.eps
        out = np.clip((obs - self.mean) / std, -self.clip, self.clip)
        batch["obs"] = out.astype(np.float32)
        return batch

    def get_state(self) -> dict:
        return {
            "count": self.count,
            "mean": None if self.mean is None else self.mean.copy(),
            "m2": None if self.m2 is None else self.m2.copy(),
        }

    def set_state(self, state: dict) -> None:
        # Working stats only: the delta buffer keeps accumulating so
        # nothing reported later is lost to the broadcast overwrite.
        self.count = state["count"]
        self.mean = None if state["mean"] is None else state["mean"].copy()
        self.m2 = None if state["m2"] is None else state["m2"].copy()

    def report_delta(self) -> dict:
        if self._d_count == 0:
            return {}
        delta = {
            "count": self._d_count,
            "mean": self._d_mean.copy(),
            "m2": self._d_m2.copy(),
        }
        self._d_count = 0.0
        self._d_mean = np.zeros_like(self._d_mean)
        self._d_m2 = np.zeros_like(self._d_m2)
        return delta

    def absorb_delta(self, delta: dict) -> None:
        if not delta or delta["count"] == 0:
            return
        self._ensure(len(delta["mean"]))
        self.count, self.mean, self.m2 = _pool_moments(
            self.count, self.mean, self.m2,
            delta["count"], delta["mean"], delta["m2"],
        )
