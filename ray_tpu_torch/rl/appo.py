"""APPO: asynchronous PPO on the IMPALA architecture (port of
ray_tpu/rl/appo.py; reference: rllib/algorithms/appo/appo.py — IMPALA's
async actor-learner loop with a PPO clipped-surrogate loss, V-trace
off-policy correction computed against a periodically-refreshed TARGET
network, and an optional KL penalty toward that target; loss math in
appo/torch/appo_torch_learner.py).

The same async rollout consumption as rl/impala.py (the learner takes
whichever runner's rollout lands first), with the V-trace recursion and
clipped update in one learner step; the target network is a second param
tree on the learner's device, carried as an extra loss arg and refreshed
in place under no_grad — no separate actor, no weight copy off the
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.rl.algorithm import make_adam
from ray_tpu_torch.rl.impala import (
    IMPALA,
    IMPALAConfig,
    ROLLOUT_AXES,
    _normalized,
    vtrace_targets,
)
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.module import tree_leaves, tree_map


def appo_loss(
    params,
    module,
    batch,
    target_params,
    clip_eps,
    gamma,
    rho_clip,
    c_clip,
    vf_coeff,
    ent_coeff,
    kl_coeff,
    dp_mean=None,
):
    """Clipped surrogate on V-trace advantages; targets and the KL
    anchor come from the TARGET network (reference: APPOTorchLearner
    compute_loss_for_module — old_target_policy drives v-trace).
    ``dp_mean``: see impala's ``_normalized``."""
    T, N = batch["actions"].shape
    obs = batch["obs"].reshape(T * N, -1)
    out = module.forward(params, obs)
    logits = out["logits"].reshape(T, N, -1)
    values = out["value"].reshape(T, N)
    logp_all = torch.log_softmax(logits, -1)
    actions = batch["actions"][..., None].long()
    logp = torch.gather(logp_all, -1, actions)[..., 0]

    # Gradients are taken w.r.t. params only; the target network is a
    # separate loss argument that needs none.
    with torch.no_grad():
        tgt = module.forward(target_params, obs)
        tgt_logits = tgt["logits"].reshape(T, N, -1)
        tgt_values = tgt["value"].reshape(T, N)
        tgt_logp_all = torch.log_softmax(tgt_logits, -1)
        tgt_logp = torch.gather(tgt_logp_all, -1, actions)[..., 0]

        # V-trace with ratios of the TARGET policy vs the behavior policy
        # (the target changes slowly, so the correction stays stable
        # while the online policy takes several clipped steps against
        # it).
        rhos = torch.exp(tgt_logp - batch["logp"])
        last_value = module.forward(target_params, batch["next_obs"])["value"]
        discounts = gamma * (1.0 - batch["dones"])
        vs, pg_adv = vtrace_targets(
            tgt_values, last_value, batch["rewards"], discounts, rhos,
            rho_clip, c_clip,
        )
        pg_adv = _normalized(pg_adv, dp_mean)

    # PPO clipped surrogate: the ONLINE policy's ratio vs behavior.
    ratio = torch.exp(logp - batch["logp"])
    surrogate = -torch.minimum(
        ratio * pg_adv,
        torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * pg_adv,
    ).mean()

    vf_loss = 0.5 * ((vs - values) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    # KL(target || online): keeps the online policy from drifting far
    # from the policy that anchors the V-trace targets.
    kl = (
        (torch.exp(tgt_logp_all) * (tgt_logp_all - logp_all))
        .sum(-1)
        .mean()
    )
    loss = (
        surrogate
        + vf_coeff * vf_loss
        - ent_coeff * entropy
        + kl_coeff * kl
    )
    return loss, {
        "policy_loss": surrogate,
        "vf_loss": vf_loss,
        "entropy": entropy,
        "kl_to_target": kl,
        "mean_rho": rhos.mean(),
        "clip_frac": (torch.abs(ratio - 1) > clip_eps).float().mean(),
    }


@dataclass(frozen=True)
class APPOConfig(IMPALAConfig):
    clip_eps: float = 0.3
    kl_coeff: float = 0.1
    # Learner updates between target-network refreshes (reference:
    # target_network_update_freq, counted in env steps there).
    target_update_freq: int = 8

    def build(self) -> "APPO":
        return APPO(self)


class APPO(IMPALA):
    """IMPALA's async loop (sample consumption, connector sync,
    runner refresh) with the APPO loss and a target network — the only
    differences ARE the loss and the target refresh, expressed through
    IMPALA's _extra_update_args/_after_update hooks."""

    def __init__(self, config: APPOConfig):
        super().__init__(config)
        self._updates_since_target = 0
        self.target_params = tree_map(torch.clone, self.learner.params)

    def _make_learner(self) -> Learner:
        cfg = self.config

        def loss(params, module, batch, target_params):
            return appo_loss(
                params, module, batch, target_params, cfg.clip_eps,
                cfg.gamma, cfg.rho_clip, cfg.c_clip, cfg.vf_coeff,
                cfg.ent_coeff, cfg.kl_coeff, dp_mean=self.learner.dp_mean,
            )

        return Learner(
            self.module, loss, make_adam(cfg.lr), mesh=cfg.mesh,
            seed=cfg.seed, device=cfg.device, batch_axes=ROLLOUT_AXES,
        )

    def _extra_update_args(self) -> tuple:
        return (self.target_params,)

    def _after_update(self) -> None:
        self._updates_since_target += 1
        if self._updates_since_target >= self.config.target_update_freq:
            with torch.no_grad():
                for t, o in zip(tree_leaves(self.target_params),
                                tree_leaves(self.learner.params)):
                    t.copy_(o)
            self._updates_since_target = 0
