"""IMPALA: asynchronous actor-learner with V-trace off-policy correction
(port of ray_tpu/rl/impala.py; reference: rllib/algorithms/impala/
impala.py + the vtrace math in rllib/algorithms/impala/vtrace_*.py;
Espeholt et al. 2018).

Rollouts arrive asynchronously from CPU env-runner actors (each keeps
sampling with slightly stale weights — the point of IMPALA); the learner
consumes whichever rollout finishes first. The V-trace recursion is a
reversed loop over the rollout's time steps on the learner's device (no
host round trip per step), in place of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, make_adam
from ray_tpu_torch.rl.learner import Learner


def vtrace_targets(values, last_value, rewards, discounts, rhos,
                   rho_clip, c_clip):
    """V-trace value targets ``vs`` [T, N] and the policy-gradient
    advantages (before normalization), from detached inputs:
    vs_t - V_t = delta_t + discount_t * c_t * (vs_{t+1} - V_{t+1}),
    accumulated backward over time."""
    clipped_rho = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = clipped_rho * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(last_value)
    out = []
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        out.append(acc)
    vs = values + torch.stack(out[::-1])
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = clipped_rho * (rewards + discounts * vs_next - values)
    return vs, pg_adv


# A rollout's row axis under a dp learner (rl/learner.py): the env
# columns N of its [T, N] leaves, so each rank runs whole v-trace
# recursions and bootstraps from its own columns' next_obs [N, ...].
ROLLOUT_AXES = {"obs": 1, "actions": 1, "rewards": 1, "dones": 1,
                "logp": 1, "next_obs": 0}


def _normalized(x, dp_mean=None):
    """Advantages normalised by the whole batch's mean and population
    std; ``dp_mean`` (a dp learner's ``Learner.dp_mean``) takes both
    over its ranks' equal shards."""
    if dp_mean is None:
        return (x - x.mean()) / (x.std(correction=0) + 1e-8)
    mean = dp_mean(x.mean())
    var = dp_mean(((x - mean) ** 2).mean())
    return (x - mean) / (var.sqrt() + 1e-8)


def vtrace_loss(
    params, module, batch, gamma, rho_clip, c_clip, vf_coeff, ent_coeff,
    dp_mean=None,
):
    """V-trace targets + policy gradient on [T, N] rollouts (``dp_mean``:
    see ``_normalized``)."""
    T, N = batch["actions"].shape
    obs = batch["obs"].reshape(T * N, -1)
    out = module.forward(params, obs)
    logits = out["logits"].reshape(T, N, -1)
    values = out["value"].reshape(T, N)
    logp_all = torch.log_softmax(logits, -1)
    logp = torch.gather(
        logp_all, -1, batch["actions"][..., None].long()
    )[..., 0]

    # Importance ratios vs the BEHAVIOR policy that sampled the rollout.
    rhos = torch.exp(logp - batch["logp"])

    # Bootstrap from the CURRENT critic at the rollout's next_obs — the
    # runner's own value estimate is as stale as its policy, and
    # V-trace's correction assumes V comes from the learner's critic.
    last_value = module.forward(params, batch["next_obs"])["value"].detach()
    discounts = gamma * (1.0 - batch["dones"])
    # Every use of the targets is under a stop-gradient.
    vs, pg_adv = vtrace_targets(
        values.detach(), last_value, batch["rewards"], discounts,
        rhos.detach(), rho_clip, c_clip,
    )
    # Normalize advantages per batch (smooths the sparse-reward, small-
    # batch regime; the reference's IMPALA exposes the same switch as
    # _separate_vf_optimizer-era configs do for PPO).
    pg_adv = _normalized(pg_adv, dp_mean)
    pg_loss = -(pg_adv * logp).mean()
    vf_loss = 0.5 * ((vs - values) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    loss = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
    return loss, {
        "policy_loss": pg_loss,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "mean_rho": rhos.mean(),
    }


@dataclass(frozen=True)
class IMPALAConfig(AlgorithmConfig):
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_coeff: float = 0.5
    ent_coeff: float = 0.02
    # Extra passes over each rollout: later passes are off-policy w.r.t.
    # the updated params, which is exactly what the rho/c clipping
    # corrects — buys faster value-function warm-up per sample.
    updates_per_rollout: int = 4

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA(Algorithm):
    def __init__(self, config: IMPALAConfig):
        super().__init__(config)
        # ref → runner handle for in-flight async sample requests.
        self._inflight: dict = {}

    def _make_learner(self) -> Learner:
        cfg = self.config

        def loss(params, module, batch):
            return vtrace_loss(
                params, module, batch, cfg.gamma, cfg.rho_clip,
                cfg.c_clip, cfg.vf_coeff, cfg.ent_coeff,
                dp_mean=self.learner.dp_mean,
            )

        return Learner(
            self.module, loss, make_adam(cfg.lr), mesh=cfg.mesh,
            seed=cfg.seed, device=cfg.device, batch_axes=ROLLOUT_AXES,
        )

    # -- subclass hooks (APPO rides this loop; rl/appo.py) ---------------
    def _extra_update_args(self) -> tuple:
        """Extra positional args for the learner's loss (APPO: the
        target-network params)."""
        return ()

    def _after_update(self) -> None:
        """Called after each learner update (APPO: target refresh)."""

    def training_step(self) -> dict:
        # Keep one sample request outstanding per runner; consume the
        # FIRST one to finish (async actor-learner — other runners keep
        # sampling with whatever weights they last saw; V-trace corrects
        # the policy lag).
        if not self._inflight:
            self._inflight = {
                r.sample.remote(): r for r in self.runners.runners
            }
        ready, _ = ray_tpu_torch.wait(
            list(self._inflight), num_returns=1, timeout=120
        )
        if not ready:
            raise TimeoutError(
                f"{type(self).__name__}: no env-runner rollout completed "
                f"within 120s ({len(self._inflight)} outstanding) — envs "
                "hung or cluster overloaded"
            )
        ref = ready[0]
        runner = self._inflight.pop(ref)
        s = ray_tpu_torch.get(ref)
        self._record_episodes([s])
        if s.get("connector_state"):
            # Absorb this runner's filter deltas; non-blocking — the
            # other runners' set_connector_state calls queue behind
            # their in-flight rollouts, and awaiting them here would
            # turn the async loop into a barrier.
            self.runners.sync_connectors(
                [s["connector_state"]], blocking=False
            )

        batch = {
            "obs": s["obs"],
            "actions": s["actions"],
            "rewards": s["rewards"],
            "dones": s["dones"],
            "logp": s["logp"],
            "next_obs": s["next_obs"],
        }
        for _ in range(max(1, self.config.updates_per_rollout)):
            metrics = self.learner.update(
                batch, *self._extra_update_args()
            )
            self._after_update()
        # Refresh only the runner that just reported, then put it back
        # to work; the rest run behind by design.
        runner.set_weights.remote(self.learner.get_weights())
        self._inflight[runner.sample.remote()] = runner
        metrics["num_env_steps_sampled"] = int(s["rewards"].size)
        return metrics

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()
