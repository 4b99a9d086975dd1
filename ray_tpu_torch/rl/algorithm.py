"""Algorithm: the driver-side train loop (sample → learn → broadcast)
(port of ray_tpu/rl/algorithm.py).

Reference: rllib/algorithms/algorithm.py:212 (`step` :1191 /
`training_step` :2301) — config object builds the algorithm, `train()`
runs one iteration and returns a metrics dict, checkpoints via
save/restore. Here the learner lives in the driver process on
``AlgorithmConfig.device`` (a GPU by default) and sampling fans out over
EnvRunner actors on the CPU.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field, replace
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.module import MLPModule, RLModule, tree_leaves


@dataclass(frozen=True)
class AlgorithmConfig:
    """Builder-style config (reference: AlgorithmConfig.environment()/
    .env_runners()/.training() chains; here a frozen dataclass with
    replace())."""

    env: str = "CartPole"
    env_kwargs: dict = field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_len: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    hidden: tuple = (64, 64)
    seed: int = 0
    mesh: Any = None  # a DeviceMesh (its dp axis: see learner.py), or None
    # env-to-module ConnectorPipeline (rl/connectors.py); every runner
    # gets a copy, running stats sync through the group.
    connectors: Any = None
    # The learner's device (the Learner refuses "cuda" without a GPU: no
    # fallback); env runners stay on the CPU.
    device: str = "cuda"

    def copy(self, **kwargs) -> "AlgorithmConfig":
        return replace(self, **kwargs)

    def build(self) -> "Algorithm":
        raise NotImplementedError


class Algorithm:
    """Base: holds module, learner, runner group; subclass implements
    training_step()."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        probe = make_env(config.env, **config.env_kwargs)
        self.module = self._make_module(probe)
        self.learner = self._make_learner()
        self.runners = EnvRunnerGroup(
            config.env,
            self.module,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_len=config.rollout_len,
            env_kwargs=config.env_kwargs,
            seed=config.seed,
            connectors=config.connectors,
        )
        self.runners.set_weights(self.learner.get_weights())
        self.iteration = 0
        self._return_window: list[float] = []

    # -- subclass hooks ----------------------------------------------------
    def _make_module(self, probe_env) -> RLModule:
        return MLPModule(
            observation_size=probe_env.observation_size,
            num_actions=probe_env.num_actions,
            hidden=self.config.hidden,
        )

    def _make_learner(self):
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    # -- public API --------------------------------------------------------
    def train(self) -> dict:
        metrics = self.training_step()
        self.iteration += 1
        window = self._return_window[-100:]
        metrics.update(
            training_iteration=self.iteration,
            episode_return_mean=float(np.mean(window)) if window else float("nan"),
            episodes_total=len(self._return_window),
        )
        return metrics

    def _record_episodes(self, samples: list[dict]) -> None:
        for s in samples:
            self._return_window.extend(s["episode_returns"])

    def stop(self) -> None:
        """Kill rollout actors and release their resources (reference:
        Algorithm.stop / EnvRunnerGroup.stop)."""
        import ray_tpu_torch

        for r in self.runners.runners:
            try:
                ray_tpu_torch.kill(r)
            # tpulint: allow(broad-except reason=stop() kills best-effort; a runner that already died is exactly the state stop wants)
            except Exception:
                pass

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        connectors = self.runners.connectors
        with open(os.path.join(path, "algorithm.pkl"), "wb") as f:
            pickle.dump(
                {
                    "weights": self.learner.get_weights(),
                    "iteration": self.iteration,
                    "config": self.config,
                    # Filter statistics are part of the policy: a net
                    # trained on normalized obs is garbage without them.
                    "connector_state": (
                        connectors.get_state() if connectors else None
                    ),
                },
                f,
            )
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "algorithm.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_weights(state["weights"])
        self.iteration = state["iteration"]
        self.runners.set_weights(self.learner.get_weights())
        cstate = state.get("connector_state")
        if cstate and self.runners.connectors is not None:
            self.runners.broadcast_connector_state(cstate)

    def get_policy_weights(self) -> Any:
        return self.learner.get_weights()

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        """Greedy action for a batch of observations (serving path), on
        the learner's device. Observations run through the SAME connector
        pipeline the policy trained on (stats frozen — serving must not
        mutate them)."""
        if self.runners.connectors is not None:
            obs = self.runners.connectors(
                {"obs": np.asarray(obs)},
                {"phase": "step", "update_stats": False},
            )["obs"]
        with torch.no_grad():
            out = self.module.forward(
                self.learner.params,
                torch.as_tensor(np.asarray(obs), device=self.learner.device))
        return out["logits"].argmax(-1).cpu().numpy()


class ClippedAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr)) by hand, with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8, no weight decay) and
    operation order: the clip scales by max_norm / norm when the norm is
    at least max_norm; the moments are bias-corrected by 1 - b**count,
    count starting at 1 after the first update."""

    def __init__(self, lr: float, grad_clip: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.grad_clip = lr, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def update(self, grads: list, state: dict, params: list):
        """-> (new param leaves, new state, the gradients' global norm
        before clipping)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip  # on the device: no host sync
        grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                 for g in grads]
        count = state["count"] + 1
        mu = [(1 - self.b1) * g + self.b1 * m
              for g, m in zip(grads, state["mu"])]
        nu = [(1 - self.b2) * (g * g) + self.b2 * v
              for g, v in zip(grads, state["nu"])]
        one = np.float32(1.0)
        bc1 = float(one - np.float32(self.b1) ** np.float32(count))
        bc2 = float(one - np.float32(self.b2) ** np.float32(count))
        new = [p + (-self.lr) * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
               for p, m, v in zip(params, mu, nu)]
        return new, {"count": count, "mu": mu, "nu": nu}, norm


def make_adam(lr: float, grad_clip: float = 0.5) -> ClippedAdam:
    return ClippedAdam(lr, grad_clip)
