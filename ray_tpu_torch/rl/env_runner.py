"""EnvRunner actors: CPU rollout workers sampling trajectories (port of
ray_tpu/rl/env_runner.py).

Mirrors the reference's EnvRunnerGroup of remote workers (reference:
rllib/env/env_runner_group.py:70, single_agent_env_runner.py): each runner
actor holds a vector of envs plus a CPU copy of the module params, samples
fixed-length rollouts, and returns flat numpy batches. Inference inside the
runner is a torch forward on the CPU under no_grad — rollouts never touch
the GPU, which stays dedicated to the learner. Actions are drawn with
numpy (Gumbel and epsilon draws), so the same seed and weights give the
same actions as the JAX package's runner.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.module import RLModule, params_to_torch


class EnvRunner:
    """Steps `num_envs` env copies for `rollout_len` steps per sample() call."""

    def __init__(
        self,
        env_name: str,
        env_kwargs: dict,
        module: RLModule,
        num_envs: int,
        rollout_len: int,
        seed: int,
        connectors=None,
    ):
        self.module = module
        self.rollout_len = rollout_len
        self.envs = [make_env(env_name, **env_kwargs) for _ in range(num_envs)]
        self.obs = np.stack([e.reset(seed + i) for i, e in enumerate(self.envs)])
        self.params = None
        self._rng = np.random.default_rng(seed)
        self._episode_returns = np.zeros(num_envs)
        self._completed: list[float] = []
        self._fwd = _cpu_forward(module)
        # env-to-module connector pipeline (reference: connectors/
        # env_to_module) — each runner actor owns its copy; running
        # stats are merged by the group after sampling.
        self.connectors = connectors

    def set_weights(self, params: Any) -> None:
        self.params = params_to_torch(params)

    def get_connector_state(self) -> dict:
        return self.connectors.get_state() if self.connectors else {}

    def set_connector_state(self, state: dict) -> None:
        if self.connectors:
            self.connectors.set_state(state)

    def _module_obs(self, obs: np.ndarray, update_stats: bool = True):
        """Run the env-to-module pipeline; the transformed view is both
        what the policy sees and what lands in the rollout buffer."""
        if self.connectors is None:
            return obs
        out = self.connectors(
            {"obs": obs.copy()},
            {"phase": "step", "update_stats": update_stats},
        )
        return out["obs"]

    def sample(self, epsilon: float = 0.0) -> dict:
        """Collect [T, N, ...] batches; also returns logp/value for PPO."""
        T, N = self.rollout_len, len(self.envs)
        obs_buf = np.zeros((T, N, self.envs[0].observation_size), np.float32)
        act_buf = np.zeros((T, N), np.int64)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)

        for t in range(T):
            mobs = self._module_obs(self.obs)
            out = self._fwd(self.params, mobs)
            logits = np.asarray(out["logits"])
            values = np.asarray(out["value"])
            # Sample from the categorical policy (Gumbel trick), with
            # optional epsilon-greedy override for DQN-style exploration.
            noise = self._rng.gumbel(size=logits.shape)
            actions = np.argmax(logits + noise, axis=-1)
            if epsilon > 0.0:
                randomize = self._rng.random(N) < epsilon
                actions = np.where(
                    randomize,
                    self._rng.integers(0, self.envs[0].num_actions, N),
                    actions,
                )
            logp = logits - _logsumexp(logits)
            obs_buf[t] = mobs
            act_buf[t] = actions
            val_buf[t] = values
            logp_buf[t] = logp[np.arange(N), actions]
            for i, env in enumerate(self.envs):
                nobs, r, done = env.step(int(actions[i]))
                rew_buf[t, i] = r
                done_buf[t, i] = float(done)
                self._episode_returns[i] += r
                if done:
                    self._completed.append(self._episode_returns[i])
                    self._episode_returns[i] = 0.0
                    nobs = env.reset()
                self.obs[i] = nobs

        # Bootstrap value for the state after the last step (PPO GAE).
        # update_stats=False: this obs is re-transformed (and counted)
        # at the start of the next sample().
        next_mobs = self._module_obs(self.obs, update_stats=False)
        last_val = np.asarray(self._fwd(self.params, next_mobs)["value"])
        completed, self._completed = self._completed, []
        sample = {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "logp": logp_buf,
            "values": val_buf,
            "last_value": last_val,
            "next_obs": next_mobs.copy(),
            "episode_returns": completed,
        }
        if self.connectors is not None:
            sample = self.connectors(sample, {"phase": "batch"})
            # Deltas only (cleared on report): the group absorbs them
            # into the global state and rebroadcasts — absolute states
            # would re-count shared history once per runner per sync.
            sample["connector_state"] = self.connectors.report_delta()
        return sample


def _cpu_forward(module: RLModule):
    """``module.forward`` on the CPU under no_grad, numpy in and out."""

    def fwd(params, obs):
        with torch.no_grad():
            out = module.forward(params, torch.from_numpy(
                np.ascontiguousarray(obs, dtype=np.float32)))
        return {k: v.numpy() for k, v in out.items()}

    return fwd


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(-1, keepdims=True))


class EnvRunnerGroup:
    """Fan-out over EnvRunner actors (reference: EnvRunnerGroup.foreach_worker)."""

    def __init__(
        self,
        env_name: str,
        module: RLModule,
        *,
        num_runners: int = 2,
        num_envs_per_runner: int = 4,
        rollout_len: int = 64,
        env_kwargs: dict | None = None,
        seed: int = 0,
        connectors=None,
    ):
        # Driver-side pipeline copy: used to merge the per-runner
        # running stats (reference: FilterManager.synchronize_filters).
        self.connectors = connectors
        runner_cls = ray_tpu_torch.remote(EnvRunner)
        self.runners = [
            runner_cls.remote(
                env_name,
                env_kwargs or {},
                module,
                num_envs_per_runner,
                rollout_len,
                seed + 1000 * i,
                connectors,
            )
            for i in range(num_runners)
        ]

    def set_weights(self, params) -> None:
        ray_tpu_torch.get([r.set_weights.remote(params) for r in self.runners])

    def sample(self, epsilon: float = 0.0) -> list[dict]:
        samples = ray_tpu_torch.get(
            [r.sample.remote(epsilon) for r in self.runners]
        )
        self.sync_connectors(
            [s.get("connector_state", {}) for s in samples]
        )
        return samples

    def sync_connectors(
        self, deltas: list[dict], blocking: bool = True
    ) -> None:
        """Absorb per-runner delta reports into the driver's global
        pipeline state and rebroadcast it, so every runner normalizes
        with the same view and every observation is pooled exactly
        once. Async algorithms pass ``blocking=False``: actor calls
        execute in order, so awaiting the broadcast would barrier on
        every runner's in-flight rollout."""
        if self.connectors is None:
            return
        deltas = [d for d in deltas if d]
        if not deltas:
            return
        self.connectors.absorb_deltas(deltas)
        self.broadcast_connector_state(
            self.connectors.get_state(), blocking=blocking
        )

    def broadcast_connector_state(
        self, state: dict, blocking: bool = True
    ) -> None:
        """Push a full pipeline state to every runner (sync tail +
        checkpoint restore share this fanout)."""
        if self.connectors is not None:
            self.connectors.set_state(state)
        refs = [
            r.set_connector_state.remote(state) for r in self.runners
        ]
        if blocking:
            ray_tpu_torch.get(refs)
