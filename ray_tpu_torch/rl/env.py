"""Minimal vectorizable env API + built-in envs (numpy, no gym dependency).

The reference wraps external gymnasium envs (reference:
rllib/env/env_runner.py, rllib/examples use gym.make); this image ships no
gym, so the framework defines the same reset/step surface and registers
envs by name. User envs implementing this protocol plug into
:class:`ray_tpu_torch.rl.EnvRunnerGroup` unchanged.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class Env:
    """Single-episode env protocol: reset() -> obs, step(a) -> (obs, r, done)."""

    observation_size: int
    num_actions: int

    def reset(self, seed: int | None = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole balancing, the reference test-suite workhorse.

    Dynamics follow the standard OpenAI formulation (Euler integration,
    force +-10N, fail at |x|>2.4 or |theta|>12deg, 500-step limit).
    """

    observation_size = 4
    num_actions = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180
    MAX_STEPS = 500

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(4, np.float64)
        self._t = 0

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._t = 0
        return self._state.astype(np.float32)

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        x, x_dot, th, th_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos, sin = np.cos(th), np.sin(th)
        temp = (force + pole_ml * th_dot**2 * sin) / total_mass
        th_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos**2 / total_mass)
        )
        x_acc = temp - pole_ml * th_acc * cos / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        th += self.DT * th_dot
        th_dot += self.DT * th_acc
        self._state = np.array([x, x_dot, th, th_dot])
        self._t += 1
        done = (
            abs(x) > self.X_LIMIT
            or abs(th) > self.THETA_LIMIT
            or self._t >= self.MAX_STEPS
        )
        return self._state.astype(np.float32), 1.0, bool(done)


class ChainEnv(Env):
    """Deterministic N-state chain: action 1 moves right (+1 reward at the
    end), action 0 resets to the start. Trivially learnable — used by fast
    tests the way the reference uses toy envs in rllib/examples."""

    num_actions = 2

    def __init__(self, n: int = 8, seed: int = 0):
        self.n = n
        self.observation_size = n
        self._pos = 0

    def _obs(self) -> np.ndarray:
        obs = np.zeros(self.n, np.float32)
        obs[self._pos] = 1.0
        return obs

    def reset(self, seed: int | None = None) -> np.ndarray:
        self._pos = 0
        return self._obs()

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        if action == 1:
            self._pos += 1
        else:
            self._pos = 0
        if self._pos >= self.n - 1:
            return self._obs(), 1.0, True
        return self._obs(), 0.0, False


_REGISTRY: dict[str, Callable[..., Env]] = {}


def register_env(name: str, creator: Callable[..., Env]) -> None:
    """Register an env constructor under a string id (reference:
    rllib `tune.register_env`)."""
    _REGISTRY[name] = creator


def make_env(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown env {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


register_env("CartPole", CartPole)
register_env("Chain", ChainEnv)
