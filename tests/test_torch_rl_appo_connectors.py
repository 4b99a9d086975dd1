"""The JAX package's APPO + connector cases
(tests/test_rl_appo_connectors.py) on the port: the learner on the CPU
(``device="cpu"``), tensors where the reference builds jax arrays, the
envs, pipelines and asserts unchanged."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from torch_runtime_util import start_cluster, stop_cluster
from ray_tpu_torch.rl import (
    APPOConfig,
    CastObs,
    ClipReward,
    ConnectorPipeline,
    MeanStdObsFilter,
    PPOConfig,
)


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


# ---------------------------------------------------------------- APPO


def test_appo_loss_finite_and_clipped():
    from ray_tpu_torch.rl.appo import appo_loss
    from ray_tpu_torch.rl.module import MLPModule

    mod = MLPModule(observation_size=3, num_actions=2, hidden=(8,))
    params = mod.init(torch.Generator().manual_seed(0))
    target = mod.init(torch.Generator().manual_seed(1))
    T, N = 4, 2
    obs = np.zeros((T, N, 3), np.float32)
    batch = {
        "obs": torch.as_tensor(obs),
        "actions": torch.zeros((T, N), dtype=torch.int32),
        "rewards": torch.ones((T, N)),
        "dones": torch.zeros((T, N)),
        "logp": torch.full((T, N), -0.7),
        "next_obs": torch.zeros((N, 3)),
    }
    loss, aux = appo_loss(
        params, mod, batch, target, clip_eps=0.3, gamma=0.9,
        rho_clip=1.0, c_clip=1.0, vf_coeff=0.5, ent_coeff=0.0,
        kl_coeff=0.1,
    )
    assert np.isfinite(float(loss))
    assert float(aux["kl_to_target"]) >= 0.0
    assert 0.0 <= float(aux["clip_frac"]) <= 1.0


def test_appo_learns_chain(cluster):
    cfg = APPOConfig(
        env="Chain",
        env_kwargs={"n": 6},
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        lr=3e-3,
        target_update_freq=4,
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


def test_appo_target_network_refreshes(cluster):
    cfg = APPOConfig(
        env="Chain",
        env_kwargs={"n": 4},
        num_env_runners=1,
        num_envs_per_runner=2,
        rollout_len=8,
        hidden=(8,),
        target_update_freq=1000,  # never, within this test
        updates_per_rollout=1,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        from ray_tpu_torch.rl.module import tree_leaves

        before = tree_leaves(algo.target_params)[0].clone()
        algo.train()
        after = tree_leaves(algo.target_params)[0]
        np.testing.assert_array_equal(before, after)  # frozen target

        algo._updates_since_target = 999  # next update crosses freq
        algo.train()
        online = tree_leaves(algo.learner.params)[0]
        np.testing.assert_array_equal(
            tree_leaves(algo.target_params)[0].numpy(),
            online.numpy(),
        )
    finally:
        algo.stop()


# ----------------------------------------------------------- connectors


def test_pipeline_mutation_surface():
    pipe = ConnectorPipeline(CastObs(), ClipReward())
    pipe.insert_before("ClipReward", MeanStdObsFilter())
    names = [c.name for c in pipe.connectors]
    assert names == ["CastObs", "MeanStdObsFilter", "ClipReward"]
    pipe.insert_after("CastObs", ClipReward(low=-2, high=2))
    assert [c.name for c in pipe.connectors][1] == "ClipReward"
    pipe.remove("MeanStdObsFilter")
    assert "MeanStdObsFilter" not in [c.name for c in pipe.connectors]
    with pytest.raises(KeyError):
        pipe.remove("nope")


def test_mean_std_filter_normalizes_and_pools_deltas():
    f = MeanStdObsFilter()
    obs = np.array([[10.0, 0.0], [12.0, 0.0], [8.0, 0.0]], np.float32)
    out = f({"obs": obs}, {"phase": "step"})["obs"]
    assert abs(out[:, 0].mean()) < 1.0  # roughly centered

    # Two runner filters each see a different half; the driver absorbs
    # their DELTAS and must recover the full-data moments exactly.
    driver = MeanStdObsFilter()
    a, b = MeanStdObsFilter(), MeanStdObsFilter()
    rng = np.random.default_rng(0)
    xa = rng.normal(5, 2, size=(50, 3))
    xb = rng.normal(-5, 2, size=(70, 3))
    a({"obs": xa}, {"phase": "step"})
    b({"obs": xb}, {"phase": "step"})
    driver.absorb_delta(a.report_delta())
    driver.absorb_delta(b.report_delta())
    full = np.concatenate([xa, xb])
    state = driver.get_state()
    assert state["count"] == 120
    np.testing.assert_allclose(state["mean"], full.mean(0), rtol=1e-6)
    np.testing.assert_allclose(
        state["m2"] / (state["count"] - 1), full.var(0, ddof=1), rtol=1e-6
    )


def test_filter_sync_rounds_count_each_obs_once():
    """Regression: absolute-state pooling re-counts broadcast history
    once per runner per round (count would grow ~n_runners x per sync);
    delta shipping keeps the global count exactly equal to the number
    of observations ever seen."""
    driver = MeanStdObsFilter()
    runners = [MeanStdObsFilter(), MeanStdObsFilter()]
    rng = np.random.default_rng(1)
    for round_i in range(5):
        deltas = []
        for r in runners:
            r({"obs": rng.normal(size=(8, 2))}, {"phase": "step"})
            deltas.append(r.report_delta())
        for d in deltas:
            driver.absorb_delta(d)
        merged = driver.get_state()
        for r in runners:
            r.set_state(merged)
        assert merged["count"] == 16 * (round_i + 1)


def test_clip_reward_is_batch_phase():
    pipe = ConnectorPipeline(ClipReward(low=-1, high=1))
    step = pipe({"obs": np.zeros((2, 2))}, {"phase": "step"})
    assert "rewards" not in step
    batch = pipe(
        {"rewards": np.array([5.0, -3.0, 0.5])}, {"phase": "batch"}
    )
    np.testing.assert_array_equal(batch["rewards"], [1.0, -1.0, 0.5])


def test_ppo_with_connectors_learns_and_syncs(cluster):
    """End-to-end: PPO trains THROUGH a normalizing pipeline on an env
    with offset observations, and the runner filters converge to one
    shared state."""
    pipe = ConnectorPipeline(CastObs(), MeanStdObsFilter())
    cfg = PPOConfig(
        env="Chain",
        env_kwargs={"n": 6},
        num_env_runners=2,
        num_envs_per_runner=4,
        rollout_len=32,
        hidden=(32,),
        lr=3e-3,
        connectors=pipe,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        result = {}
        for _ in range(40):
            result = algo.train()
        assert np.isfinite(result["loss"])
        assert result["episode_return_mean"] > 0.4
        # Driver-side pipeline holds the merged stats from all runners.
        state = algo.runners.connectors.get_state()["MeanStdObsFilter"]
        assert state["count"] > 0
        # Every runner converged to the same pooled count.
        counts = {
            ray_tpu_torch.get(r.get_connector_state.remote())[
                "MeanStdObsFilter"
            ]["count"]
            for r in algo.runners.runners
        }
        assert len(counts) == 1
    finally:
        algo.stop()


def test_impala_syncs_connector_deltas(cluster):
    """The async loop (IMPALA and APPO both ride it) absorbs each
    consumed rollout's filter deltas — they must not drop on the
    floor."""
    from ray_tpu_torch.rl import IMPALAConfig

    cfg = IMPALAConfig(
        env="Chain",
        env_kwargs={"n": 4},
        num_env_runners=2,
        num_envs_per_runner=2,
        rollout_len=8,
        hidden=(8,),
        updates_per_rollout=1,
        connectors=ConnectorPipeline(MeanStdObsFilter()),
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        for _ in range(4):
            algo.train()
        state = algo.runners.connectors.get_state()["MeanStdObsFilter"]
        assert state["count"] > 0
    finally:
        algo.stop()


def test_save_restore_carries_connector_state(cluster, tmp_path):
    """Filter statistics are part of the policy: a restored checkpoint
    must normalize with the stats it trained with."""
    pipe = ConnectorPipeline(MeanStdObsFilter())
    cfg = PPOConfig(
        env="Chain",
        env_kwargs={"n": 4},
        num_env_runners=1,
        num_envs_per_runner=2,
        rollout_len=8,
        hidden=(8,),
        connectors=pipe,
        seed=0,
        device="cpu",
    )
    algo = cfg.build()
    try:
        algo.train()
        saved_state = algo.runners.connectors.get_state()[
            "MeanStdObsFilter"
        ]
        assert saved_state["count"] > 0
        algo.save(str(tmp_path / "ckpt"))

        # Wreck the live stats, then restore: they must come back.
        algo.runners.connectors.set_state(
            {"MeanStdObsFilter": {"count": 0.0, "mean": None, "m2": None}}
        )
        algo.restore(str(tmp_path / "ckpt"))
        got = algo.runners.connectors.get_state()["MeanStdObsFilter"]
        assert got["count"] == saved_state["count"]
        np.testing.assert_allclose(got["mean"], saved_state["mean"])

        # compute_actions normalizes through the restored pipeline
        # (and must not mutate its statistics).
        algo.compute_actions(np.zeros((1, 4), np.float32))
        assert (
            algo.runners.connectors.get_state()["MeanStdObsFilter"][
                "count"
            ]
            == saved_state["count"]
        )
    finally:
        algo.stop()


def test_duplicate_connector_instances_sync_independently():
    """Regression: two instances of the same connector class in one
    pipeline must not share a state-sync key — with class-name keying,
    one instance's filter state silently overwrote the other's."""
    runner = ConnectorPipeline(MeanStdObsFilter(), MeanStdObsFilter())
    rng = np.random.default_rng(2)
    runner({"obs": rng.normal(5, 1, size=(20, 2))}, {"phase": "step"})
    report = runner.report_delta()
    assert set(report) == {"MeanStdObsFilter", "MeanStdObsFilter_1"}
    # The second filter sees the FIRST one's normalized output, so the
    # two deltas must differ — distinct instances, distinct stats.
    assert report["MeanStdObsFilter"]["mean"][0] != pytest.approx(
        report["MeanStdObsFilter_1"]["mean"][0]
    )
    driver = ConnectorPipeline(MeanStdObsFilter(), MeanStdObsFilter())
    driver.absorb_deltas([report])
    state = driver.get_state()
    np.testing.assert_allclose(
        state["MeanStdObsFilter"]["mean"],
        report["MeanStdObsFilter"]["mean"],
    )
    np.testing.assert_allclose(
        state["MeanStdObsFilter_1"]["mean"],
        report["MeanStdObsFilter_1"]["mean"],
    )
    # Round-trip: set_state routes each keyed state to its own instance.
    fresh = ConnectorPipeline(MeanStdObsFilter(), MeanStdObsFilter())
    fresh.set_state(state)
    assert fresh.connectors[0].count != fresh.connectors[1].count or (
        not np.allclose(fresh.connectors[0].mean, fresh.connectors[1].mean)
    )
