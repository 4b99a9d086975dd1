"""The JAX package's multi-agent and offline RL cases
(tests/test_multi_agent_rl.py, tests/test_offline_rl.py) on the port:
MultiChain, policy mapping, shared and independent PPO policies, and
record -> parquet -> BC -> evaluation through the port's Data, the learners
on the CPU, the envs and asserts unchanged.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl.multi_agent import (
    MultiAgentEnvRunner,
    MultiAgentPPOConfig,
    MultiAgentSpec,
    MultiChain,
    make_multi_agent_env,
)
from ray_tpu_torch.rl.offline import (
    OfflineBCConfig,
    dataset_report,
    evaluate_policy,
    record_rollouts,
)
from ray_tpu_torch.rl.module import params_from_jax
from ray_tpu_torch.rl.ppo import PPOConfig
from torch_runtime_util import start_cluster, stop_cluster


@pytest.fixture(scope="module")
def cluster():
    info = start_cluster(num_cpus=8)
    yield info
    stop_cluster(info)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # The learners' MLPs are too small for intra-op threads; under a
    # loaded suite they only contend.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- env
def test_multichain_protocol():
    env = MultiChain(lengths=(4, 6))
    assert env.agent_ids == ("agent_0", "agent_1")
    obs = env.reset(0)
    assert set(obs) == {"agent_0", "agent_1"}
    assert obs["agent_0"].shape == (4,)
    assert obs["agent_1"].shape == (6,)
    # agent_0 walks its 4-chain: done after 3 right-moves; agent_1
    # keeps resetting and stays alive until it finishes too.
    for _ in range(3):
        obs, rew, done = env.step({"agent_0": 1, "agent_1": 0})
    assert done["agent_0"] and rew["agent_0"] == 1.0
    assert not done["agent_1"] and not done["__all__"]
    # Finished agents idle at zero reward with static shapes.
    obs, rew, done = env.step({"agent_0": 1, "agent_1": 1})
    assert done["agent_0"] and rew["agent_0"] == 0.0
    for _ in range(5):
        obs, rew, done = env.step({"agent_0": 0, "agent_1": 1})
    assert done["__all__"]


def test_policy_mapping_validated():
    spec = MultiAgentSpec(
        modules={"p0": object()},
        policy_mapping_fn=lambda aid: "nope",
    )
    with pytest.raises(KeyError, match="nope"):
        spec.policy_of("agent_0")


# ------------------------------------------------------------- runner
def test_runner_routes_agents_by_policy_mapping(cluster):
    """The policy mapping decides which policy's batch an agent's
    transitions land in — and changing the mapping reroutes them."""
    from ray_tpu_torch.rl.module import MLPModule

    modules = {
        "left": MLPModule(observation_size=5, num_actions=2),
        "right": MLPModule(observation_size=5, num_actions=2),
    }

    def all_left(aid):
        return "left"

    runner = MultiAgentEnvRunner(
        "MultiChain", {"lengths": (5, 5)},
        MultiAgentSpec(modules, all_left),
        num_envs=2, rollout_len=4, seed=0,
    )
    assert len(runner.slots["left"]) == 4  # 2 envs x 2 agents
    assert runner.slots["right"] == []
    params = {
        pid: m.init(torch.Generator().manual_seed(i))
        for i, (pid, m) in enumerate(modules.items())
    }
    runner.set_weights(params)
    batch = runner.sample()
    assert batch["left"]["obs"].shape == (4, 4, 5)  # [T, slots, D]
    assert "right" not in batch

    def split(aid):
        return "left" if aid == "agent_0" else "right"

    rerouted = MultiAgentEnvRunner(
        "MultiChain", {"lengths": (5, 5)},
        MultiAgentSpec(modules, split),
        num_envs=2, rollout_len=4, seed=0,
    )
    assert [aid for _, aid in rerouted.slots["left"]] == [
        "agent_0", "agent_0",
    ]
    assert [aid for _, aid in rerouted.slots["right"]] == [
        "agent_1", "agent_1",
    ]
    rerouted.set_weights(params)
    b2 = rerouted.sample()
    assert b2["left"]["obs"].shape == (4, 2, 5)
    assert b2["right"]["obs"].shape == (4, 2, 5)


# ----------------------------------------------------------- training
def _train_until(algo, target, max_iters):
    best = -np.inf
    for _ in range(max_iters):
        m = algo.train()
        r = m["episode_return_mean"]
        if np.isfinite(r):
            best = max(best, r)
        if best >= target:
            break
    return best, m


def test_independent_policies_both_improve(cluster):
    """Two agents on different-length chains, one policy each: both
    policies' losses update and the joint return reaches near-max
    (both agents finishing their chains)."""
    algo = MultiAgentPPOConfig(
        env="MultiChain",
        env_kwargs={"lengths": (5, 7)},
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        seed=0,
    ).build()
    assert set(algo.learners) == {"agent_0", "agent_1"}
    best, metrics = _train_until(algo, target=1.9, max_iters=30)
    # Joint episode return: 1.0 per agent for finishing its chain.
    assert best >= 1.9, f"joint return plateaued at {best}"
    for pid in ("agent_0", "agent_1"):
        assert "loss" in metrics[pid]
        assert metrics[pid]["num_env_steps_sampled"] > 0


def test_shared_policy_trains_on_all_agents(cluster):
    """All agents mapped to ONE shared policy: its batch carries every
    agent's transitions and the shared policy still solves the env."""
    algo = MultiAgentPPOConfig(
        env="MultiChain",
        env_kwargs={"lengths": (6, 6)},
        policy_mapping_fn=lambda aid: "shared",
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        seed=1,
    ).build()
    assert set(algo.learners) == {"shared"}
    best, metrics = _train_until(algo, target=1.9, max_iters=30)
    assert best >= 1.9, f"joint return plateaued at {best}"
    # Shared batch sees 2 agents x envs x runners worth of steps.
    assert metrics["shared"]["num_env_steps_sampled"] == 2 * 2 * 4 * 32


def test_shared_policy_shape_mismatch_rejected():
    with pytest.raises(ValueError, match="maps to policy"):
        MultiAgentPPOConfig(
            env="MultiChain",
            env_kwargs={"lengths": (4, 8)},  # different obs sizes
            policy_mapping_fn=lambda aid: "shared",
        ).build()


def test_make_env_unknown_name():
    with pytest.raises(KeyError, match="MultiChain"):
        make_multi_agent_env("NoSuchEnv")


# ------------------------------------------------------------- offline
def _reference_init(algo, seed):
    """Start ``algo`` from the JAX package's initial weights for ``seed``
    (its Learner draws ``module.init(jax.random.key(seed))``)."""
    import jax

    from ray_tpu.rl.module import MLPModule as JaxMLPModule

    m = algo.module
    weights = JaxMLPModule(
        observation_size=m.observation_size, num_actions=m.num_actions,
        hidden=m.hidden,
    ).init(jax.random.key(seed))
    algo.learner.set_weights(weights)
    algo.learner.opt_state = algo.learner.optimizer.init(algo.learner.params)
    algo.runners.set_weights(algo.learner.get_weights())


@pytest.fixture(scope="module")
def recorded(cluster, tmp_path_factory):
    """Train PPO briefly on the chain, then record its rollouts. PPO here
    is seed-sensitive in both packages (of seeds 0-5 the JAX package's
    learns the chain in 12 iterations from 0, 1 and 2 only), and torch's
    draw for seed 0 is not the JAX package's: the port starts from the
    reference's seed-0 weights, so both record from the same policy."""
    path = str(tmp_path_factory.mktemp("episodes"))
    algo = PPOConfig(
        env="Chain", env_kwargs={"n": 6},
        num_env_runners=2, num_envs_per_runner=4, rollout_len=32,
        lr=3e-3, seed=0, device="cpu",
    ).build()
    _reference_init(algo, 0)
    for _ in range(12):
        algo.train()
    summary = record_rollouts(algo, path, num_rounds=3)
    algo.stop()
    return path, summary


def test_recording_writes_episode_schema(recorded):
    import ray_tpu_torch.data as rdata

    path, summary = recorded
    assert summary["rows"] > 0 and summary["episodes"] > 0
    ds = rdata.read_parquet(path)
    row = ds.take(1)[0]
    assert set(row) >= {"eps_id", "t", "obs", "action", "reward", "done"}
    assert len(row["obs"]) == 6  # chain obs size
    assert ds.count() == summary["rows"]


def test_dataset_report_behavior_stats(recorded):
    path, summary = recorded
    report = dataset_report(path)
    assert report["rows"] == summary["rows"]
    assert report["episodes_completed"] > 0
    # A mostly-trained behavior policy finishes chains: positive mean.
    assert report["behavior_return_mean"] > 0.3


def test_bc_from_parquet_beats_random(recorded):
    """The end-to-end offline claim: BC trained purely from the files
    recovers a policy whose LIVE evaluated return beats random by a
    wide margin (random on a 6-chain almost never finishes; the cloned
    policy nearly always does)."""
    path, _ = recorded
    algo = OfflineBCConfig(
        env="Chain", env_kwargs={"n": 6},
        input_path=path, batch_size=256, updates_per_step=16,
        lr=3e-3, seed=0, device="cpu",
    ).build()
    for _ in range(10):
        metrics = algo.train()
    assert metrics["accuracy"] > 0.8  # clones the behavior actions
    assert metrics["epoch"] >= 2  # shuffled windowed epochs cycled

    module, params = algo.get_policy()
    ev = evaluate_policy(
        module, params, "Chain", env_kwargs={"n": 6},
        n_episodes=20, max_steps=30,
    )
    # The random baseline is the reference's: its key-123 weights (near
    # uniform: the policy head is drawn at scale 0.01), sampled by the
    # same numpy generator. A random walk finishes a 6-chain within 30
    # steps often enough that another draw of the weights moves the
    # baseline across the margin below.
    import jax

    from ray_tpu.rl.module import MLPModule as JaxMLPModule

    rand_module = algo.module
    rand_params = params_from_jax(JaxMLPModule(
        observation_size=rand_module.observation_size,
        num_actions=rand_module.num_actions, hidden=rand_module.hidden,
    ).init(jax.random.key(123)))
    rand_ev = evaluate_policy(
        rand_module, rand_params, "Chain",
        env_kwargs={"n": 6}, n_episodes=20, max_steps=30,
        greedy=False,
    )
    assert ev["return_mean"] > 0.9
    assert ev["return_mean"] > rand_ev["return_mean"] + 0.5


def test_offline_bc_requires_input_path():
    with pytest.raises(ValueError, match="input_path"):
        OfflineBCConfig(env="Chain", device="cpu").build()
