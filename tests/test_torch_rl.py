"""The JAX package's RL cases (tests/test_rl.py, tests/test_rl_algos.py)
on the port: envs, replay, GAE, and PPO, DQN, IMPALA, SAC and BC training
on the port's runtime, the learner on the CPU (``device="cpu"``), the
envs and asserts unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl import (
    BCConfig,
    CartPole,
    DQNConfig,
    IMPALAConfig,
    PPOConfig,
    ReplayBuffer,
    SACConfig,
    make_env,
)
from ray_tpu_torch.rl.ppo import compute_gae
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=4)
    yield info
    stop_cluster(info)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The learner's MLPs are too small for intra-op threads; under a
    # loaded suite they only contend.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------ tests/test_rl.py
def test_cartpole_dynamics():
    env = CartPole(seed=0)
    obs = env.reset()
    assert obs.shape == (4,)
    total = 0.0
    done = False
    while not done:
        obs, r, done = env.step(1)  # constant push falls over quickly
        total += r
    assert 1 <= total < 500


def test_env_registry():
    env = make_env("Chain", n=5)
    obs = env.reset()
    assert obs.argmax() == 0
    for _ in range(4):
        obs, r, done = env.step(1)
    assert done and r == 1.0


def test_replay_buffer_wraps():
    buf = ReplayBuffer(capacity=10, observation_size=3)
    for i in range(4):
        n = 4
        buf.add_batch(
            np.full((n, 3), i, np.float32),
            np.zeros(n, np.int64),
            np.ones(n, np.float32),
            np.zeros(n, np.float32),
            np.zeros((n, 3), np.float32),
        )
    assert len(buf) == 10
    batch = buf.sample(8)
    assert batch["obs"].shape == (8, 3)


def test_gae_matches_manual():
    # Single env, 3 steps, no terminations: check recursion by hand.
    r = np.array([[1.0], [1.0], [1.0]], np.float32)
    v = np.array([[0.5], [0.5], [0.5]], np.float32)
    d = np.zeros((3, 1), np.float32)
    last = np.array([0.5], np.float32)
    adv, ret = compute_gae(r, v, d, last, gamma=1.0, lam=1.0)
    # delta_t = 1 + v_{t+1} - v_t = 1; adv_t = sum of remaining deltas
    np.testing.assert_allclose(adv[:, 0], [3.0, 2.0, 1.0])
    np.testing.assert_allclose(ret, adv + v)


def test_ppo_learns_chain(cluster):
    cfg = PPOConfig(
        env="Chain",
        env_kwargs={"n": 6},
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        lr=3e-3,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        first = algo.train()
        assert np.isfinite(first["loss"])
        for _ in range(14):
            result = algo.train()
        # The optimal policy reaches the chain end every 5 steps → mean
        # return near 1.0 per episode; random policy rarely finishes.
        assert result["episode_return_mean"] > 0.5
        assert result["training_iteration"] == 15

        # Greedy policy walks right from the start state.
        obs = np.zeros((1, 6), np.float32)
        obs[0, 0] = 1.0
        assert algo.compute_actions(obs)[0] == 1
    finally:
        algo.stop()


def test_ppo_checkpoint_roundtrip(cluster, tmp_path):
    cfg = PPOConfig(
        env="Chain", env_kwargs={"n": 4}, num_env_runners=1,
        num_envs_per_runner=2, rollout_len=8, hidden=(16,), seed=1,
        device="cpu",
    )
    algo = cfg.build()
    algo2 = None
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))

        algo2 = cfg.build()
        algo2.restore(path)
        assert algo2.iteration == 1
        w1 = algo.get_policy_weights()
        w2 = algo2.get_policy_weights()
        # Checkpoints hold numpy trees, as the reference's do.
        assert isinstance(w1["policy"]["w"], np.ndarray)
        np.testing.assert_allclose(
            w1["policy"]["w"], w2["policy"]["w"], rtol=1e-6
        )
    finally:
        algo.stop()
        if algo2 is not None:
            algo2.stop()


def test_dqn_trains(cluster):
    cfg = DQNConfig(
        env="Chain",
        env_kwargs={"n": 5},
        num_env_runners=1,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        learning_starts=64,
        epsilon_decay_iters=8,
        num_updates_per_iter=8,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        for _ in range(10):
            result = algo.train()
        assert result["buffer_size"] > 64
        assert np.isfinite(result["loss"])
        assert result["epsilon"] < 1.0
    finally:
        algo.stop()


# ------------------------------------------------ tests/test_rl_algos.py
def test_vtrace_matches_onpolicy_gae_limit():
    """With behavior == target policy (rho=c=1) and gamma-only
    discounting, vs reduces to the Monte-Carlo-corrected TD recursion —
    check one step by hand via the loss's aux values."""
    from ray_tpu_torch.rl.impala import vtrace_loss
    from ray_tpu_torch.rl.module import MLPModule

    mod = MLPModule(observation_size=3, num_actions=2, hidden=(8,))
    params = mod.init(torch.Generator().manual_seed(0))
    T, N = 4, 2
    obs = np.zeros((T, N, 3), np.float32)
    out = mod.forward(params, obs.reshape(-1, 3))
    logp_all = torch.log_softmax(out["logits"], -1).reshape(T, N, -1)
    actions = np.zeros((T, N), np.int64)
    batch = {
        "obs": torch.as_tensor(obs),
        "actions": torch.as_tensor(actions),
        "rewards": torch.ones((T, N)),
        "dones": torch.zeros((T, N)),
        "logp": logp_all[..., 0],  # behavior == target → rho = 1
        "next_obs": torch.zeros((N, 3)),
    }
    loss, aux = vtrace_loss(
        params, mod, batch, gamma=0.9, rho_clip=1.0, c_clip=1.0,
        vf_coeff=0.5, ent_coeff=0.0,
    )
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(aux["mean_rho"]), 1.0, rtol=1e-5)


def test_impala_learns_chain(cluster):
    cfg = IMPALAConfig(
        env="Chain",
        env_kwargs={"n": 6},
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        lr=3e-3,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        result = {}
        for _ in range(80):
            result = algo.train()
        assert np.isfinite(result["loss"])
        assert result["episode_return_mean"] > 0.5
        obs = np.zeros((1, 6), np.float32)
        obs[0, 0] = 1.0
        assert algo.compute_actions(obs)[0] == 1
    finally:
        algo.stop()


def test_sac_learns_chain(cluster):
    cfg = SACConfig(
        env="Chain",
        env_kwargs={"n": 5},
        num_env_runners=1,
        num_envs_per_runner=8,
        rollout_len=32,
        hidden=(32,),
        lr=3e-3,
        learning_starts=256,
        batch_size=128,
        updates_per_step=16,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        result = {}
        for _ in range(20):
            result = algo.train()
        assert np.isfinite(result["q_loss"])
        assert result["alpha"] > 0
        assert result["episode_return_mean"] > 0.5
    finally:
        algo.stop()


def _expert_chain_dataset(n=6, episodes=200):
    """Optimal Chain policy: always go right (action 1)."""
    env = make_env("Chain", n=n)
    obs_list, act_list = [], []
    for ep in range(episodes):
        obs = env.reset(seed=ep)
        done = False
        while not done:
            obs_list.append(obs.copy())
            act_list.append(1)
            obs, _r, done = env.step(1)
    return {"obs": np.array(obs_list), "actions": np.array(act_list)}


def test_bc_clones_expert(cluster):
    data = _expert_chain_dataset()
    cfg = BCConfig(
        env="Chain",
        env_kwargs={"n": 6},
        num_env_runners=1,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        lr=1e-2,
        dataset=data,
        evaluate_every=5,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        result = {}
        for _ in range(10):
            result = algo.train()
        assert result["accuracy"] > 0.95
        assert result["episode_return_mean"] > 0.8  # clone reaches goal
    finally:
        algo.stop()


def test_cuda_learner_refused_without_a_gpu(monkeypatch):
    """The learner's device defaults to cuda; without a GPU build()
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PPOConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        PPOConfig(env="Chain", env_kwargs={"n": 4}).build()
