"""The port's RL math against the JAX package's (ray_tpu/rl/), module by
module, and PPO on the chain as a whole.

Weights come from the JAX package's ``init`` through
``params_from_jax``; batches are drawn with numpy from a seed; everything
is fp32. Each loss and each of its gradients, the forwards, GAE and three
``Learner.update`` steps under ``make_adam`` agree to TOL (1e-5, relative
with an absolute floor of the same size). The slice case runs the JAX
package's PPO in a subprocess (one runtime per process) and carries its
initial weights across: the first iteration's sampled batch is equal,
and so is the second's, sampled with weights that still agree to ~1e-7
(a Gumbel draw flips an action only on a near-tie of 1e-7); the
learner's loss and grad_norm agree to 1e-4 over both iterations.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import appo as j_appo
from ray_tpu.rl import bc as j_bc
from ray_tpu.rl import dqn as j_dqn
from ray_tpu.rl import impala as j_impala
from ray_tpu.rl import ppo as j_ppo
from ray_tpu.rl import sac as j_sac
from ray_tpu.rl.algorithm import make_adam as j_make_adam
from ray_tpu.rl.learner import Learner as JLearner
from ray_tpu.rl.module import MLPModule as JMLP
from ray_tpu_torch.rl import appo, bc, dqn, impala, ppo, sac
from ray_tpu_torch.rl.algorithm import make_adam
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.module import (
    MLPModule,
    params_from_jax,
    tree_leaves,
)
from torch_runtime_util import start_cluster, stop_cluster

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
OBS, ACTS, HIDDEN = 6, 3, (16, 16)


def close(got, want, tol=TOL, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _modules(cls_j, cls_t, **kw):
    return (cls_j(observation_size=OBS, num_actions=ACTS, **kw),
            cls_t(observation_size=OBS, num_actions=ACTS, **kw))


def _flat_batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "next_obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, n).astype(np.int32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": (rng.random(n) < 0.2).astype(np.float32),
        "logp_old": np.log(rng.uniform(0.2, 0.6, n)).astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }


def _rollout_batch(seed, T=8, N=4):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, (T, N)).astype(np.int32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "logp": np.log(rng.uniform(0.2, 0.6, (T, N))).astype(np.float32),
        "next_obs": rng.normal(size=(N, OBS)).astype(np.float32),
    }


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _check_loss(j_loss, t_loss, jmod, tmod, jp, batch, *extra_j,
                extra_t=()):
    """Loss, every aux value and every gradient leaf of the two losses."""
    (jl, jaux), jg = jax.value_and_grad(j_loss, has_aux=True)(
        jp, jmod, _j(batch), *extra_j)
    leaves = [t.requires_grad_(True) for t in
              tree_leaves(params_from_jax(jp))]
    from ray_tpu_torch.rl.module import tree_unflatten

    tp = tree_unflatten(params_from_jax(jp), leaves)
    tl, taux = t_loss(tp, tmod, _t(batch), *extra_t)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    close(tl, jl, what="loss")
    assert set(taux) == set(jaux)
    for k in jaux:
        close(taux[k], jaux[k], what=k)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (g, want) in enumerate(zip(tg, jleaves)):
        got = torch.zeros_like(leaves[i]) if g is None else g
        close(got, want, what=f"grad leaf {i}")
    return float(jl)


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("dueling", [False, True])
def test_mlp_forward(dueling):
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN, dueling=dueling)
    jp = jmod.init(jax.random.key(3))
    obs = np.random.default_rng(0).normal(size=(32, OBS)).astype(np.float32)
    want = jmod.forward(jp, jnp.asarray(obs))
    got = tmod.forward(params_from_jax(jp), obs)
    for k in ("logits", "value"):
        close(got[k], want[k], what=k)


def test_sac_module_forward_and_q_values():
    jmod, tmod = _modules(j_sac.SACModule, sac.SACModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(4))
    jp["log_alpha"] = jnp.float32(-0.3)
    tp = params_from_jax(jp)
    obs = np.random.default_rng(1).normal(size=(32, OBS)).astype(np.float32)
    for got, want in zip(tmod.q_values(tp, obs),
                         jmod.q_values(jp, jnp.asarray(obs))):
        close(got, want)
    want = jmod.forward(jp, jnp.asarray(obs))
    got = tmod.forward(tp, obs)
    for k in ("logits", "value"):
        close(got[k], want[k], what=k)


def test_compute_gae_equals_reference():
    rng = np.random.default_rng(2)
    T, N = 16, 5
    args = (rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            (rng.random((T, N)) < 0.2).astype(np.float32),
            rng.normal(size=N).astype(np.float32))
    got = ppo.compute_gae(*args, gamma=0.97, lam=0.9)
    want = j_ppo.compute_gae(*args, gamma=0.97, lam=0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- losses
def test_ppo_loss_and_grads():
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(5))
    keys = ("obs", "actions", "logp_old", "advantages", "returns")
    batch = {k: v for k, v in _flat_batch(0).items() if k in keys}
    _check_loss(lambda p, m, b: j_ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01),
                lambda p, m, b: ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01),
                jmod, tmod, jp, batch)


def test_vtrace_loss_and_grads():
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(6))
    args = (0.95, 1.0, 1.0, 0.5, 0.02)
    _check_loss(lambda p, m, b: j_impala.vtrace_loss(p, m, b, *args),
                lambda p, m, b: impala.vtrace_loss(p, m, b, *args),
                jmod, tmod, jp, _rollout_batch(1))


def test_appo_loss_and_grads():
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(7))
    jt = jmod.init(jax.random.key(8))
    args = (0.3, 0.95, 1.0, 1.0, 0.5, 0.02, 0.1)
    _check_loss(lambda p, m, b, t: j_appo.appo_loss(p, m, b, t, *args),
                lambda p, m, b, t: appo.appo_loss(p, m, b, t, *args),
                jmod, tmod, jp, _rollout_batch(2), jt,
                extra_t=(params_from_jax(jt),))


def test_dqn_loss_and_grads():
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN, dueling=True)
    jp = jmod.init(jax.random.key(9))
    jt = jmod.init(jax.random.key(10))
    keys = ("obs", "next_obs", "actions", "rewards", "dones")
    batch = {k: v for k, v in _flat_batch(3).items() if k in keys}
    # Rewards large enough that some TD errors pass the Huber knee.
    batch["rewards"] = batch["rewards"] * 3
    _check_loss(lambda p, m, b, t: j_dqn.dqn_loss(p, m, b, t, 0.99),
                lambda p, m, b, t: dqn.dqn_loss(p, m, b, t, 0.99),
                jmod, tmod, jp, batch, jt, extra_t=(params_from_jax(jt),))


def test_sac_loss_and_grads():
    jmod, tmod = _modules(j_sac.SACModule, sac.SACModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(11))
    jp["log_alpha"] = jnp.float32(-0.5)
    jt = jmod.init(jax.random.key(12))
    keys = ("obs", "next_obs", "actions", "rewards", "dones")
    batch = {k: v for k, v in _flat_batch(4).items() if k in keys}
    target_entropy = 0.5 * float(np.log(ACTS))
    _check_loss(
        lambda p, m, b, t: j_sac.sac_loss(p, m, b, t, 0.99, target_entropy),
        lambda p, m, b, t: sac.sac_loss(p, m, b, t, 0.99, target_entropy),
        jmod, tmod, jp, batch, jt, extra_t=(params_from_jax(jt),))


def test_bc_loss_and_grads():
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN)
    jp = jmod.init(jax.random.key(13))
    batch = {k: v for k, v in _flat_batch(5).items()
             if k in ("obs", "actions")}
    _check_loss(j_bc.bc_loss, bc.bc_loss, jmod, tmod, jp, batch)


# -------------------------------------------------------------- learner
@pytest.mark.parametrize("grad_clip", [0.5, 1e3])
def test_learner_three_updates(grad_clip):
    """Three PPO updates under make_adam (global-norm clipping on at 0.5,
    off at 1e3): loss, grad_norm and every param leaf after each."""
    jmod, tmod = _modules(JMLP, MLPModule, hidden=HIDDEN)

    def j_loss(p, m, b):
        return j_ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01)

    def t_loss(p, m, b):
        return ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01)

    jl = JLearner(jmod, j_loss, j_make_adam(3e-3, grad_clip), seed=0)
    tl = Learner(tmod, t_loss, make_adam(3e-3, grad_clip), seed=0)
    tl.set_weights(jl.get_weights())
    tl.opt_state = tl.optimizer.init(tl.params)
    keys = ("obs", "actions", "logp_old", "advantages", "returns")
    for i in range(3):
        batch = {k: v for k, v in _flat_batch(10 + i).items() if k in keys}
        want = jl.update(_j(batch))
        got = tl.update(batch)
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], what=f"update {i} {k}")
        clipped = want["grad_norm"] >= grad_clip
        assert clipped == (grad_clip == 0.5)
        for a, b in zip(tree_leaves(tl.params), jax.tree.leaves(jl.params)):
            close(a, b, what=f"update {i} params")
    assert tl.optimizer.init(tl.params)["count"] == 0


# The name is from when a dp mesh was refused; it now checks the rows.
def test_learner_refuses_a_dp_mesh():
    """A dp mesh is no longer refused: the learner builds, and rank 1 of
    dp = 2 takes the second half of every leaf along its row axis (axis 0
    unless ``batch_axes`` names another), and the whole batch when some
    row axis does not split evenly. tests/test_torch_rl_dp.py runs it on
    two ranks."""
    class Mesh:
        mesh_dim_names = ("dp", "tp")

        def size(self, dim=None):
            return (2, 1)[dim] if dim is not None else 2

        def get_local_rank(self, name):
            return {"dp": 1, "tp": 0}[name]

    learner = Learner(MLPModule(observation_size=OBS, num_actions=ACTS),
                      ppo.ppo_loss, make_adam(1e-3), mesh=Mesh(),
                      batch_axes={"cols": 1})
    rows = torch.arange(24).reshape(6, 4)
    got = learner._shard({"rows": rows, "cols": rows, "s": rows[0, 0]})
    assert torch.equal(got["rows"], rows[3:])
    assert torch.equal(got["cols"], rows[:, 2:])
    assert torch.equal(got["s"], rows[0, 0])
    whole = learner._shard({"rows": rows[:5], "cols": rows[:5]})
    assert torch.equal(whole["rows"], rows[:5])
    assert torch.equal(whole["cols"], rows[:5])


# ---------------------------------------------------------------- slice
_JAX_PPO = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import ray_tpu
    from ray_tpu.rl import PPOConfig

    ray_tpu.init(num_cpus=4)
    algo = PPOConfig(**pickle.loads(bytes.fromhex(sys.argv[2]))).build()
    out = {"init": algo.learner.get_weights(), "samples": [],
           "metrics": []}
    sample = algo.runners.sample

    def recording(*a, **k):
        s = sample(*a, **k)
        out["samples"].append([{k: x[k] for k in ("obs", "actions",
                                                  "rewards", "dones")}
                               for x in s])
        return s

    algo.runners.sample = recording
    for _ in range(2):
        out["metrics"].append(algo.train())
    out["final"] = algo.learner.get_weights()
    algo.stop()
    ray_tpu.shutdown()
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""")

PPO_KW = dict(env="Chain", env_kwargs={"n": 6}, num_env_runners=2,
              num_envs_per_runner=4, rollout_len=32, hidden=(32,),
              lr=3e-3, seed=0)


@pytest.fixture(scope="module")
def jax_ppo(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ppo") / "out.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run(
        [sys.executable, "-c", _JAX_PPO, str(path),
         pickle.dumps(PPO_KW).hex()],
        cwd=REPO, env=env, check=True, timeout=300)
    with open(path, "rb") as f:
        return pickle.load(f)


def test_ppo_slice_equals_reference(jax_ppo):
    """PPO on the chain: the JAX package's run in a subprocess, the
    port's from the same initial weights and seed."""
    from ray_tpu_torch.rl import PPOConfig

    info = start_cluster(num_cpus=4)
    try:
        algo = PPOConfig(**PPO_KW, device="cpu").build()
        try:
            algo.learner.set_weights(jax_ppo["init"])
            algo.learner.opt_state = algo.learner.optimizer.init(
                algo.learner.params)
            algo.runners.set_weights(algo.learner.get_weights())
            samples = []
            sample = algo.runners.sample

            def recording(*a, **k):
                s = sample(*a, **k)
                samples.append(s)
                return s

            algo.runners.sample = recording
            metrics = [algo.train() for _ in range(2)]
        finally:
            algo.stop()
    finally:
        stop_cluster(info)
    for it in range(2):
        for got, want in zip(samples[it], jax_ppo["samples"][it]):
            for k in ("obs", "actions", "rewards", "dones"):
                np.testing.assert_array_equal(
                    got[k], want[k], err_msg=f"iteration {it} {k}")
        for k in ("loss", "grad_norm"):
            close(metrics[it][k], jax_ppo["metrics"][it][k], tol=1e-4,
                  what=f"iteration {it} {k}")
        assert (metrics[it]["episode_return_mean"]
                == jax_ppo["metrics"][it]["episode_return_mean"])
    final = tree_leaves(algo.learner.params)
    for a, b in zip(final, jax.tree.leaves(jax_ppo["final"])):
        close(a, b, tol=1e-4, what="final params")
