"""BC: offline behavior cloning (port of ray_tpu/rl/bc.py; reference:
rllib/algorithms/bc/bc.py — supervised imitation of a recorded dataset,
the simplest offline-RL algorithm and the reference's offline-data smoke
test).

The dataset is host numpy ({"obs": [N, D], "actions": [N]}); each
training_step runs cross-entropy minibatches on the learner's device.
Env runners are kept only for periodic evaluation of the cloned policy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, make_adam
from ray_tpu_torch.rl.learner import Learner


def bc_loss(params, module, batch):
    out = module.forward(params, batch["obs"])
    logp_all = torch.log_softmax(out["logits"], -1)
    actions = batch["actions"].long()
    logp = torch.gather(logp_all, -1, actions[:, None])[:, 0]
    loss = -logp.mean()
    acc = (out["logits"].argmax(-1) == actions).float().mean()
    return loss, {"bc_loss": loss, "accuracy": acc}


@dataclass(frozen=True)
class BCConfig(AlgorithmConfig):
    dataset: dict = field(default_factory=dict)  # {"obs", "actions"}
    batch_size: int = 256
    updates_per_step: int = 16
    evaluate_every: int = 5  # iterations between env evaluations

    def build(self) -> "BC":
        return BC(self)


class BC(Algorithm):
    def __init__(self, config: BCConfig):
        if not config.dataset:
            raise ValueError("BCConfig.dataset must hold 'obs'/'actions'")
        super().__init__(config)
        self._obs = np.asarray(config.dataset["obs"], np.float32)
        self._actions = np.asarray(config.dataset["actions"], np.int64)
        self._rng = np.random.default_rng(config.seed)

    def _make_learner(self) -> Learner:
        return Learner(
            self.module, bc_loss, make_adam(self.config.lr),
            mesh=self.config.mesh, seed=self.config.seed,
            device=self.config.device,
        )

    def training_step(self) -> dict:
        cfg = self.config
        n = len(self._obs)
        metrics: dict = {}
        for _ in range(cfg.updates_per_step):
            idx = self._rng.integers(0, n, min(cfg.batch_size, n))
            metrics = self.learner.update(
                {"obs": self._obs[idx], "actions": self._actions[idx]}
            )
        metrics["num_env_steps_sampled"] = 0
        # Offline training: evaluate the cloned policy in the env only
        # periodically (rollouts are for reporting, not learning).
        if (self.iteration + 1) % cfg.evaluate_every == 0:
            self.runners.set_weights(self.learner.get_weights())
            samples = self.runners.sample()
            self._record_episodes(samples)
        return metrics
