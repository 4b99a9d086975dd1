"""DQN: double Q-learning with target network and uniform replay (port
of ray_tpu/rl/dqn.py; reference: rllib/algorithms/dqn/dqn.py,
default_dqn_rl_module.py).

The target network is an alias of the learner's params at the last sync:
the learner replaces its params with new tensors at every update, never
writing them in place, so the alias keeps the synced values.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, make_adam
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.module import MLPModule
from ray_tpu_torch.rl.replay import ReplayBuffer


def dqn_loss(params, module, batch, target_params, gamma):
    actions = batch["actions"][:, None].long()
    q = module.forward(params, batch["obs"])["logits"]
    q_taken = torch.gather(q, -1, actions)[:, 0]
    with torch.no_grad():
        # Double DQN: online net picks the argmax, target net evaluates it.
        next_q_online = module.forward(params, batch["next_obs"])["logits"]
        next_act = next_q_online.argmax(-1)
        next_q_target = module.forward(
            target_params, batch["next_obs"])["logits"]
        next_q = torch.gather(next_q_target, -1, next_act[:, None])[:, 0]
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * next_q
    td = q_taken - target
    loss = torch.where(
        torch.abs(td) < 1.0, 0.5 * td**2, torch.abs(td) - 0.5).mean()
    return loss, {"td_error_mean": torch.abs(td).mean(),
                  "q_mean": q_taken.mean()}


@dataclass(frozen=True)
class DQNConfig(AlgorithmConfig):
    lr: float = 1e-3
    buffer_capacity: int = 50_000
    train_batch_size: int = 128
    num_updates_per_iter: int = 16
    target_update_interval: int = 4  # iterations between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 50
    learning_starts: int = 500  # min transitions before updates begin

    def build(self) -> "DQN":
        return DQN(self)


class DQN(Algorithm):
    def __init__(self, config: DQNConfig):
        super().__init__(config)
        probe = make_env(config.env, **config.env_kwargs)
        self.buffer = ReplayBuffer(
            config.buffer_capacity, probe.observation_size, seed=config.seed
        )
        self.target_params = self.learner.params

    def _make_module(self, probe_env):
        return MLPModule(
            observation_size=probe_env.observation_size,
            num_actions=probe_env.num_actions,
            hidden=self.config.hidden,
            dueling=True,
        )

    def _make_learner(self) -> Learner:
        gamma = self.config.gamma

        def loss(params, module, batch, target_params):
            return dqn_loss(params, module, batch, target_params, gamma)

        return Learner(
            self.module, loss, make_adam(self.config.lr, grad_clip=10.0),
            mesh=self.config.mesh, seed=self.config.seed,
            device=self.config.device,
        )

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def training_step(self) -> dict:
        cfg = self.config
        samples = self.runners.sample(epsilon=self._epsilon())
        self._record_episodes(samples)
        for s in samples:
            T, N, D = s["obs"].shape
            # next_obs within the rollout is obs shifted by one step; the
            # final step's successor is the runner's current obs. Resets
            # inside the rollout are fine: dones masks the bootstrap.
            next_obs = np.concatenate([s["obs"][1:], s["next_obs"][None]], 0)
            self.buffer.add_batch(
                s["obs"].reshape(-1, D),
                s["actions"].reshape(-1),
                s["rewards"].reshape(-1),
                s["dones"].reshape(-1),
                next_obs.reshape(-1, D),
            )

        metrics: dict = {"epsilon": self._epsilon(), "buffer_size": len(self.buffer)}
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                metrics.update(self.learner.update(batch, self.target_params))
            if self.iteration % cfg.target_update_interval == 0:
                self.target_params = self.learner.params
            self.runners.set_weights(self.learner.get_weights())
        return metrics
