"""Multi-agent RL: env protocol, module dict, policy mapping, PPO.

Reference: rllib/env/multi_agent_env.py (dict-keyed obs/actions/rewards
with a ``__all__`` done flag), rllib/core/rl_module/multi_rl_module.py
(a dict of RLModules keyed by module/policy id), and the
``policy_mapping_fn`` contract (algorithm_config.multi_agent(...)):
each agent id maps to a policy id; agents sharing a policy share
parameters and training batches.

Rollouts stay on CPU numpy like the single-agent runners (port of
ray_tpu/rl/multi_agent.py: only the runner's forward changed, to torch on
the CPU); the learner side is one update per POLICY (policies are
independent optimization problems — a dict of Learners, not one padded
program), so two policies of different obs sizes never force a ragged
batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ray_tpu_torch.rl.env import Env, make_env
from ray_tpu_torch.rl.env_runner import _cpu_forward
from ray_tpu_torch.rl.module import (
    MLPModule,
    RLModule,
    params_to_numpy,
    params_to_torch,
)


class MultiAgentEnv:
    """Dict-keyed episode protocol (reference: MultiAgentEnv.reset /
    step returning per-agent dicts; dones carry ``__all__``).

    Agents are FIXED for the episode (possibly_agents == agents): every
    dict is keyed by the full agent id set each step. Per-agent dones
    mark agents whose episode slice ended; ``__all__`` resets the env.
    """

    agent_ids: tuple[str, ...]
    observation_sizes: dict[str, int]
    num_actions: dict[str, int]

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def step(
        self, actions: dict[str, int]
    ) -> tuple[dict, dict, dict]:
        """-> (obs, rewards, dones) dicts; dones includes "__all__"."""
        raise NotImplementedError


class MultiChain(MultiAgentEnv):
    """N agents, each walking its own deterministic chain (the
    multi-agent analogue of the single-agent ChainEnv toy): action 1
    advances, action 0 resets to the start; +1 at the chain's end.
    Chains may differ in length per agent, so per-policy observation
    sizes genuinely differ — the shape mismatch a shared-vs-independent
    policy test needs. The episode ends when every agent has finished.
    """

    def __init__(self, lengths: "tuple[int, ...]" = (6, 6), seed: int = 0):
        self.agent_ids = tuple(f"agent_{i}" for i in range(len(lengths)))
        self._chains = {
            aid: make_env("Chain", n=n)
            for aid, n in zip(self.agent_ids, lengths)
        }
        self.observation_sizes = {
            aid: e.observation_size for aid, e in self._chains.items()
        }
        self.num_actions = {
            aid: e.num_actions for aid, e in self._chains.items()
        }
        self._done: dict[str, bool] = {}

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        self._done = {aid: False for aid in self.agent_ids}
        return {
            aid: e.reset(seed) for aid, e in self._chains.items()
        }

    def step(self, actions: dict[str, int]):
        obs, rewards, dones = {}, {}, {}
        for aid, env in self._chains.items():
            if self._done[aid]:
                # Finished agents idle at their terminal obs with zero
                # reward until __all__ (reference: agents absent from
                # the step dicts once done; fixed-key dicts keep the
                # batch shapes static instead).
                obs[aid] = env._obs()
                rewards[aid] = 0.0
                dones[aid] = True
                continue
            o, r, d = env.step(int(actions[aid]))
            obs[aid], rewards[aid], dones[aid] = o, float(r), bool(d)
            self._done[aid] = bool(d)
        dones["__all__"] = all(self._done.values())
        return obs, rewards, dones


_MA_ENVS: dict[str, Callable[..., MultiAgentEnv]] = {
    "MultiChain": MultiChain,
}


def register_multi_agent_env(name: str, creator) -> None:
    _MA_ENVS[name] = creator


def make_multi_agent_env(name: str, **kwargs) -> MultiAgentEnv:
    if name not in _MA_ENVS:
        raise KeyError(
            f"unknown multi-agent env {name!r}; registered: "
            f"{sorted(_MA_ENVS)}"
        )
    return _MA_ENVS[name](**kwargs)


@dataclass(frozen=True)
class MultiAgentSpec:
    """Policies + the agent→policy mapping (reference: the
    config.multi_agent(policies=..., policy_mapping_fn=...) pair and
    MultiRLModule's module dict)."""

    modules: "dict[str, RLModule]"
    policy_mapping_fn: Callable[[str], str]

    def policy_of(self, agent_id: str) -> str:
        pid = self.policy_mapping_fn(agent_id)
        if pid not in self.modules:
            raise KeyError(
                f"policy_mapping_fn({agent_id!r}) -> {pid!r}, which is "
                f"not in the module dict {sorted(self.modules)}"
            )
        return pid


class MultiAgentEnvRunner:
    """Rollout worker over vectorized multi-agent envs: per step, group
    observations BY POLICY, run one forward per policy, scatter actions
    back — the env-side half of the reference's multi-agent EnvRunner.
    Returns one [T, slots] batch per policy (slots = env copies x
    agents mapped to that policy)."""

    def __init__(
        self,
        env_name: str,
        env_kwargs: dict,
        spec: MultiAgentSpec,
        num_envs: int,
        rollout_len: int,
        seed: int,
    ):
        self.spec = spec
        self.rollout_len = rollout_len
        self.envs = [
            make_multi_agent_env(env_name, **env_kwargs)
            for _ in range(num_envs)
        ]
        self.agent_ids = self.envs[0].agent_ids
        # (env_i, agent_id) slots per policy, fixed for the runner's
        # lifetime: the policy's batch row order.
        self.slots: dict[str, list[tuple[int, str]]] = {
            pid: [] for pid in spec.modules
        }
        for ei in range(num_envs):
            for aid in self.agent_ids:
                self.slots[spec.policy_of(aid)].append((ei, aid))
        self.obs = [
            e.reset(seed + i) for i, e in enumerate(self.envs)
        ]
        self.params: dict[str, dict] = {}
        self._rng = np.random.default_rng(seed)
        self._fwd = {
            pid: _cpu_forward(m) for pid, m in spec.modules.items()
        }
        self._ep_return = np.zeros(num_envs)
        self._completed: list[float] = []

    def set_weights(self, params: "dict[str, dict]") -> None:
        self.params = {pid: params_to_torch(p) for pid, p in params.items()}

    def sample(self) -> "dict[str, dict]":
        """One rollout_len rollout; returns policy_id -> batch dict of
        [T, slots(, D)] arrays plus last_value for GAE bootstrap."""
        T = self.rollout_len
        out: dict[str, dict] = {}
        buf = {
            pid: {
                "obs": [], "actions": [], "logp": [], "values": [],
                "rewards": [], "dones": [],
            }
            for pid in self.slots
        }
        for _ in range(T):
            acts_per_env: list[dict[str, int]] = [
                {} for _ in self.envs
            ]
            step_cache: dict[str, tuple] = {}
            for pid, slots in self.slots.items():
                if not slots:
                    continue
                obs = np.stack(
                    [self.obs[ei][aid] for ei, aid in slots]
                )
                fwd = self._fwd[pid](self.params[pid], obs)
                logits = np.asarray(fwd["logits"])
                values = np.asarray(fwd["value"])
                z = logits - logits.max(-1, keepdims=True)
                p = np.exp(z)
                p /= p.sum(-1, keepdims=True)
                actions = np.array(
                    [
                        self._rng.choice(len(row), p=row)
                        for row in p
                    ]
                )
                logp = np.log(
                    p[np.arange(len(actions)), actions] + 1e-9
                )
                for (ei, aid), a in zip(slots, actions):
                    acts_per_env[ei][aid] = int(a)
                step_cache[pid] = (obs, actions, logp, values)
            rewards_per_env, dones_per_env = [], []
            for ei, env in enumerate(self.envs):
                obs, rew, done = env.step(acts_per_env[ei])
                self._ep_return[ei] += sum(
                    rew[aid] for aid in self.agent_ids
                )
                if done["__all__"]:
                    self._completed.append(self._ep_return[ei])
                    self._ep_return[ei] = 0.0
                    obs = env.reset()
                self.obs[ei] = obs
                rewards_per_env.append(rew)
                dones_per_env.append(done)
            for pid, slots in self.slots.items():
                if not slots:
                    continue
                obs_b, actions, logp, values = step_cache[pid]
                b = buf[pid]
                b["obs"].append(obs_b)
                b["actions"].append(actions)
                b["logp"].append(logp)
                b["values"].append(values)
                b["rewards"].append(
                    np.array(
                        [rewards_per_env[ei][aid] for ei, aid in slots]
                    )
                )
                b["dones"].append(
                    np.array(
                        [
                            float(dones_per_env[ei][aid])
                            for ei, aid in slots
                        ]
                    )
                )
        for pid, slots in self.slots.items():
            if not slots:
                continue
            b = buf[pid]
            last_obs = np.stack(
                [self.obs[ei][aid] for ei, aid in slots]
            )
            last_value = np.asarray(
                self._fwd[pid](self.params[pid], last_obs)["value"]
            )
            out[pid] = {
                "obs": np.stack(b["obs"]),
                "actions": np.stack(b["actions"]),
                "logp": np.stack(b["logp"]),
                "values": np.stack(b["values"]),
                "rewards": np.stack(b["rewards"]),
                "dones": np.stack(b["dones"]),
                "last_value": last_value,
            }
        out["episode_returns"] = self._completed
        self._completed = []
        return out


@dataclass(frozen=True)
class MultiAgentPPOConfig:
    """Multi-agent PPO over a module dict (reference: PPO +
    config.multi_agent(...)). Build with explicit modules, or let
    ``from_env`` derive one MLP policy per distinct mapped policy id
    with that policy's obs/action sizes."""

    env: str = "MultiChain"
    env_kwargs: dict = field(default_factory=dict)
    modules: "dict[str, RLModule] | None" = None
    policy_mapping_fn: Callable[[str], str] = staticmethod(
        lambda aid: aid  # independent: one policy per agent
    )
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_len: int = 32
    lr: float = 3e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    ent_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    seed: int = 0

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    def __init__(self, config: MultiAgentPPOConfig):
        import ray_tpu_torch
        from ray_tpu_torch.rl.algorithm import make_adam
        from ray_tpu_torch.rl.learner import Learner
        from ray_tpu_torch.rl.ppo import ppo_loss

        self.config = config
        probe = make_multi_agent_env(config.env, **config.env_kwargs)
        modules = config.modules
        if modules is None:
            # One MLP per distinct policy id, sized from any agent
            # mapped to it (agents sharing a policy must share shapes).
            modules = {}
            for aid in probe.agent_ids:
                pid = config.policy_mapping_fn(aid)
                if pid not in modules:
                    modules[pid] = MLPModule(
                        observation_size=probe.observation_sizes[aid],
                        num_actions=probe.num_actions[aid],
                    )
        self.spec = MultiAgentSpec(modules, config.policy_mapping_fn)
        # Shared-policy shape check: every agent mapped to a policy
        # must produce that policy's obs size.
        for aid in probe.agent_ids:
            pid = self.spec.policy_of(aid)
            want = getattr(modules[pid], "observation_size", None)
            if want is not None and probe.observation_sizes[aid] != want:
                raise ValueError(
                    f"agent {aid!r} (obs {probe.observation_sizes[aid]}) "
                    f"maps to policy {pid!r} expecting obs {want}"
                )
        cfg = config

        def loss(params, module, batch):
            return ppo_loss(
                params, module, batch,
                cfg.clip_eps, cfg.vf_coeff, cfg.ent_coeff,
            )

        self.learners = {
            pid: Learner(m, loss, make_adam(cfg.lr), seed=cfg.seed + i)
            for i, (pid, m) in enumerate(sorted(modules.items()))
        }
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(
                cfg.env,
                cfg.env_kwargs,
                self.spec,
                cfg.num_envs_per_runner,
                cfg.rollout_len,
                cfg.seed + 1000 * i,
            )
            for i in range(cfg.num_env_runners)
        ]
        self.iteration = 0
        self._episode_returns: list[float] = []
        self._broadcast()

    def _broadcast(self) -> None:
        import ray_tpu_torch

        weights = {
            pid: params_to_numpy(ln.params)
            for pid, ln in self.learners.items()
        }
        ray_tpu_torch.get(
            [r.set_weights.remote(weights) for r in self.runners]
        )

    def train(self) -> dict:
        """One iteration: sample every runner, per-policy GAE +
        minibatch PPO updates, broadcast fresh weights. Returns per-
        policy metrics plus episode_return_mean."""
        import ray_tpu_torch

        from ray_tpu_torch.rl.ppo import compute_gae

        cfg = self.config
        samples = ray_tpu_torch.get(
            [r.sample.remote() for r in self.runners]
        )
        for s in samples:
            self._episode_returns.extend(s.pop("episode_returns", []))
        self._episode_returns = self._episode_returns[-100:]
        metrics: dict = {}
        rng = np.random.default_rng(cfg.seed + self.iteration)
        for pid, learner in self.learners.items():
            parts = [s[pid] for s in samples if pid in s]
            if not parts:
                continue
            obs, acts, logp, advs, rets = [], [], [], [], []
            for s in parts:
                adv, ret = compute_gae(
                    s["rewards"], s["values"], s["dones"],
                    s["last_value"], cfg.gamma, cfg.gae_lambda,
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
            mb = min(cfg.minibatch_size, n)
            pm: dict = {}
            for _ in range(cfg.num_epochs):
                perm = rng.permutation(n)
                for start in range(0, n - mb + 1, mb):
                    idx = perm[start: start + mb]
                    pm = learner.update(
                        {
                            "obs": obs[idx],
                            "actions": acts[idx],
                            "logp_old": logp[idx],
                            "advantages": advs[idx],
                            "returns": rets[idx],
                        }
                    )
            pm["num_env_steps_sampled"] = n
            metrics[pid] = pm
        self._broadcast()
        self.iteration += 1
        metrics["episode_return_mean"] = (
            float(np.mean(self._episode_returns))
            if self._episode_returns
            else float("nan")
        )
        return metrics
