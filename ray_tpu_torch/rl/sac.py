"""SAC (discrete): twin soft Q-networks, a stochastic policy, and an
auto-tuned entropy temperature (port of ray_tpu/rl/sac.py; reference:
rllib/algorithms/sac/sac.py + sac_torch_learner; discrete variant per
Christodoulou 2019).

One learner step covers all three objectives (Q, policy, alpha) on a
single packed param tree; target networks update by polyak averaging in
place on the learner's device, under no_grad.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, make_adam
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.module import (
    MLPModule,
    RLModule,
    _as_input,
    _dense,
    _dense_init,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.rl.replay import ReplayBuffer


@dataclass(frozen=True)
class SACModule(RLModule):
    """Policy trunk + twin Q MLPs packed in one param tree."""

    hidden: tuple = (64, 64)

    def _mlp_init(self, generator, n_out):
        layers = []
        n_in = self.observation_size
        for h in self.hidden:
            layers.append(_dense_init(generator, n_in, h))
            n_in = h
        layers.append(_dense_init(generator, n_in, n_out, scale=0.01))
        return layers

    def _mlp(self, layers, x):
        for layer in layers[:-1]:
            x = torch.tanh(_dense(layer, x))
        return _dense(layers[-1], x)

    def init(self, generator: torch.Generator):
        return {
            "policy": self._mlp_init(generator, self.num_actions),
            "q1": self._mlp_init(generator, self.num_actions),
            "q2": self._mlp_init(generator, self.num_actions),
            "log_alpha": torch.zeros((), dtype=torch.float32,
                                     device=generator.device),
        }

    def q_values(self, params, obs):
        x = _as_input(params, obs)
        return self._mlp(params["q1"], x), self._mlp(params["q2"], x)

    def forward(self, params, obs) -> dict:
        """Runner-compatible view: policy logits + soft state value."""
        x = _as_input(params, obs)
        logits = self._mlp(params["policy"], x)
        q1, q2 = self.q_values(params, x)
        probs = torch.softmax(logits, -1)
        logp = torch.log_softmax(logits, -1)
        alpha = torch.exp(params["log_alpha"])
        value = (probs * (torch.minimum(q1, q2) - alpha * logp)).sum(-1)
        return {"logits": logits, "value": value}


def sac_loss(params, module, batch, target_params, gamma, target_entropy):
    obs, next_obs = batch["obs"], batch["next_obs"]
    actions = batch["actions"][:, None].long()
    alpha = torch.exp(params["log_alpha"])
    alpha_sg = alpha.detach()

    # Soft Bellman target from the TARGET twin Qs + current policy.
    with torch.no_grad():
        logits_next = module._mlp(params["policy"], next_obs)
        probs_next = torch.softmax(logits_next, -1)
        logp_next = torch.log_softmax(logits_next, -1)
        q1t, q2t = module.q_values(target_params, next_obs)
        v_next = (
            probs_next * (torch.minimum(q1t, q2t) - alpha_sg * logp_next)
        ).sum(-1)
        target_q = batch["rewards"] + gamma * (1.0 - batch["dones"]) * v_next

    q1, q2 = module.q_values(params, obs)
    q1_a = torch.gather(q1, -1, actions)[:, 0]
    q2_a = torch.gather(q2, -1, actions)[:, 0]
    q_loss = 0.5 * (
        ((q1_a - target_q) ** 2).mean() + ((q2_a - target_q) ** 2).mean()
    )

    # Policy: minimize E_pi[alpha*logpi - minQ] (exact expectation over
    # the discrete action set — no reparameterization needed).
    logits = module._mlp(params["policy"], obs)
    probs = torch.softmax(logits, -1)
    logp = torch.log_softmax(logits, -1)
    min_q = torch.minimum(q1, q2).detach()
    pi_loss = (probs * (alpha_sg * logp - min_q)).sum(-1).mean()

    # Temperature: entropy tracks target_entropy.
    entropy = -(probs * logp).sum(-1)
    alpha_loss = params["log_alpha"] * (
        entropy.mean() - target_entropy).detach()

    loss = q_loss + pi_loss + alpha_loss
    return loss, {
        "q_loss": q_loss,
        "policy_loss": pi_loss,
        "alpha": alpha,
        "entropy": entropy.mean(),
    }


@dataclass(frozen=True)
class SACConfig(AlgorithmConfig):
    buffer_capacity: int = 50_000
    batch_size: int = 256
    learning_starts: int = 1_000
    tau: float = 0.01  # polyak target update rate
    updates_per_step: int = 8
    target_entropy: float | None = None  # default 0.5*log(A)

    def build(self) -> "SAC":
        return SAC(self)


class SAC(Algorithm):
    def __init__(self, config: SACConfig):
        super().__init__(config)
        probe_obs = self.module.observation_size
        self.buffer = ReplayBuffer(
            config.buffer_capacity, probe_obs, seed=config.seed
        )
        self.target_params = tree_map(torch.clone, self.learner.params)
        tau = config.tau

        def polyak(target, online):
            with torch.no_grad():
                for t, o in zip(tree_leaves(target), tree_leaves(online)):
                    t.copy_((1 - tau) * t + tau * o)
            return target

        self._polyak = polyak

    def _make_module(self, probe_env):
        return SACModule(
            observation_size=probe_env.observation_size,
            num_actions=probe_env.num_actions,
            hidden=self.config.hidden,
        )

    def _make_learner(self) -> Learner:
        cfg = self.config
        target_entropy = cfg.target_entropy
        if target_entropy is None:
            target_entropy = 0.5 * float(np.log(self.module.num_actions))

        def loss(params, module, batch, target_params):
            return sac_loss(
                params, module, batch, target_params, cfg.gamma,
                target_entropy,
            )

        return Learner(
            self.module, loss, make_adam(cfg.lr), mesh=cfg.mesh,
            seed=cfg.seed, device=cfg.device,
        )

    def training_step(self) -> dict:
        cfg = self.config
        samples = self.runners.sample()
        self._record_episodes(samples)
        for s in samples:
            T, N = s["rewards"].shape
            obs = s["obs"].reshape(T * N, -1)
            next_obs = np.concatenate(
                [s["obs"][1:], s["next_obs"][None]], axis=0
            ).reshape(T * N, -1)
            self.buffer.add_batch(
                obs,
                s["actions"].reshape(-1),
                s["rewards"].reshape(-1),
                s["dones"].reshape(-1),
                next_obs,
            )
        metrics: dict = {}
        if len(self.buffer) >= max(cfg.learning_starts, cfg.batch_size):
            for _ in range(cfg.updates_per_step):
                batch = self.buffer.sample(cfg.batch_size)
                metrics = self.learner.update(batch, self.target_params)
                self.target_params = self._polyak(
                    self.target_params, self.learner.params
                )
        self.runners.set_weights(self.learner.get_weights())
        metrics["num_env_steps_sampled"] = sum(
            s["rewards"].size for s in samples
        )
        return metrics
