"""PPO: clipped surrogate objective + GAE (port of ray_tpu/rl/ppo.py;
reference: rllib/algorithms/ppo/ppo.py, torch policy loss in
rllib/algorithms/ppo/torch/ppo_torch_learner.py).

GAE runs on host numpy over the [T, N] rollout (a sequential scan that is
cheap on the host); the minibatch update is one learner step on the
learner's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, make_adam
from ray_tpu_torch.rl.learner import Learner


def ppo_loss(params, module, batch, clip_eps, vf_coeff, ent_coeff):
    out = module.forward(params, batch["obs"])
    logits = out["logits"]
    logp_all = torch.log_softmax(logits, -1)
    logp = torch.gather(
        logp_all, -1, batch["actions"][:, None].long()
    )[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    pg_loss = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    ).mean()
    vf_loss = 0.5 * ((out["value"] - batch["returns"]) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, {
        "policy_loss": pg_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "clip_frac": (torch.abs(ratio - 1) > clip_eps).float().mean(),
    }


def compute_gae(
    rewards: np.ndarray,  # [T, N]
    values: np.ndarray,  # [T, N]
    dones: np.ndarray,  # [T, N]
    last_value: np.ndarray,  # [N]
    gamma: float,
    lam: float,
) -> tuple[np.ndarray, np.ndarray]:
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    gae = np.zeros_like(last_value)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    return adv, adv + values


@dataclass(frozen=True)
class PPOConfig(AlgorithmConfig):
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    ent_coeff: float = 0.01
    gae_lambda: float = 0.95
    num_epochs: int = 4
    minibatch_size: int = 128

    def build(self) -> "PPO":
        return PPO(self)


class PPO(Algorithm):
    def _make_learner(self) -> Learner:
        cfg = self.config

        def loss(params, module, batch):
            return ppo_loss(
                params, module, batch, cfg.clip_eps, cfg.vf_coeff, cfg.ent_coeff
            )

        return Learner(
            self.module, loss, make_adam(cfg.lr), mesh=cfg.mesh, seed=cfg.seed,
            device=cfg.device,
        )

    def training_step(self) -> dict:
        cfg = self.config
        samples = self.runners.sample()
        self._record_episodes(samples)

        obs, acts, logp, advs, rets = [], [], [], [], []
        for s in samples:
            adv, ret = compute_gae(
                s["rewards"], s["values"], s["dones"], s["last_value"],
                cfg.gamma, cfg.gae_lambda,
            )
            obs.append(s["obs"].reshape(-1, s["obs"].shape[-1]))
            acts.append(s["actions"].reshape(-1))
            logp.append(s["logp"].reshape(-1))
            advs.append(adv.reshape(-1))
            rets.append(ret.reshape(-1))
        obs = np.concatenate(obs)
        acts = np.concatenate(acts)
        logp = np.concatenate(logp)
        advs = np.concatenate(advs)
        rets = np.concatenate(rets)
        advs = (advs - advs.mean()) / (advs.std() + 1e-8)

        n = len(obs)
        rng = np.random.default_rng(cfg.seed + self.iteration)
        metrics: dict = {}
        mb = min(cfg.minibatch_size, n)
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(n)
            for start in range(0, n - mb + 1, mb):
                idx = perm[start : start + mb]
                metrics = self.learner.update(
                    {
                        "obs": obs[idx],
                        "actions": acts[idx],
                        "logp_old": logp[idx],
                        "advantages": advs[idx],
                        "returns": rets[idx],
                    }
                )
        self.runners.set_weights(self.learner.get_weights())
        metrics["num_env_steps_sampled"] = n
        return metrics
