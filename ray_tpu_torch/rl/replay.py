"""Uniform replay buffer for off-policy algorithms (DQN).

Reference: rllib/utils/replay_buffers/replay_buffer.py — ring storage,
uniform sampling. Stored as preallocated numpy arrays so sampling is a
single fancy-index (no per-item Python objects).
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, observation_size: int, seed: int = 0):
        self.capacity = capacity
        self.obs = np.zeros((capacity, observation_size), np.float32)
        self.next_obs = np.zeros((capacity, observation_size), np.float32)
        self.actions = np.zeros((capacity,), np.int64)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, dones, next_obs) -> None:
        """Append flat [B, ...] transition arrays, wrapping at capacity."""
        n = len(actions)
        idx = (self._idx + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, batch_size: int) -> dict:
        idx = self._rng.integers(0, self._size, batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
            "next_obs": self.next_obs[idx],
        }
