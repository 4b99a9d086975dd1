"""The RL library (RLlib equivalent) on PyTorch (port of ray_tpu/rl/).

Architecture mirrors the reference's split (reference:
rllib/algorithms/algorithm.py:212, rllib/env/env_runner_group.py:70,
rllib/core/learner/learner_group.py:101, rllib/core/rl_module/):

- :class:`RLModule` — the neural net, a functional torch (init, forward)
  pair over an explicit tree of tensors.
- :class:`EnvRunnerGroup` — CPU rollout actors stepping vectorized envs,
  with a torch forward on the CPU.
- :class:`Learner` — one update (torch.autograd, then a hand-written
  clipped Adam) on the learner's device, a GPU by default.
- :class:`Algorithm` — the driver loop: sample → learn → broadcast.
"""

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.appo import APPO, APPOConfig
from ray_tpu_torch.rl.bc import BC, BCConfig
from ray_tpu_torch.rl.connectors import (
    CastObs,
    ClipObs,
    ClipReward,
    Connector,
    ConnectorPipeline,
    MeanStdObsFilter,
)
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.env import CartPole, Env, make_env, register_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.module import MLPModule, RLModule
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.sac import SAC, SACConfig

__all__ = [
    "APPO",
    "APPOConfig",
    "Algorithm",
    "AlgorithmConfig",
    "BC",
    "BCConfig",
    "CartPole",
    "CastObs",
    "ClipObs",
    "ClipReward",
    "Connector",
    "ConnectorPipeline",
    "MeanStdObsFilter",
    "DQN",
    "DQNConfig",
    "Env",
    "EnvRunnerGroup",
    "IMPALA",
    "IMPALAConfig",
    "Learner",
    "MLPModule",
    "PPO",
    "PPOConfig",
    "RLModule",
    "ReplayBuffer",
    "SAC",
    "SACConfig",
    "make_env",
    "register_env",
]


def __getattr__(name):
    if name == "Learner":
        from ray_tpu_torch.rl.learner import Learner

        return Learner
    raise AttributeError(f"module 'ray_tpu_torch.rl' has no attribute {name!r}")
