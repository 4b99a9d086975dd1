"""The RL learner's data-parallel mesh: ``Learner(mesh=...)`` with dp = 2
on two spawned gloo ranks (tests/torch_spawn_util.py), against one port
learner on the whole batch and the JAX package's ``Learner`` with a
{"dp": 2} mesh on the CPU devices.

Weights come from the JAX learner through ``get_weights``; three updates
under ``make_adam`` (clipping at 0.5, so the clip acts on the reduced
gradients) on batches drawn with numpy from a seed; metrics and params
within 1e-5 (tests/test_torch_rl_parity.py's TOL). The losses:

- ``ppo``: flat [n] rows, split on axis 0;
- ``impala`` and ``appo``: [T, N] rollouts with T and N both even. The
  rows are the env columns N (``impala.ROLLOUT_AXES``), so each rank runs
  whole v-trace recursions, and the advantages are normalised by the
  whole batch's statistics; APPO also takes a target network;
- ``impala_odd_n``: N = 3 does not split over dp = 2, so every rank
  takes the whole rollout.

This module's top level imports torch, numpy and ray_tpu_torch only.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.mesh import make_mesh
from ray_tpu_torch.rl import appo, impala, ppo
from ray_tpu_torch.rl.algorithm import make_adam
from ray_tpu_torch.rl.learner import Learner
from ray_tpu_torch.rl.module import MLPModule, params_to_torch, tree_leaves

TOL = 1e-5
OBS, ACTS, HIDDEN = 6, 3, (16, 16)
CLIP, UPDATES = 0.5, 3
VTRACE = (0.95, 1.0, 1.0, 0.5, 0.02)  # gamma, rho/c clips, vf, entropy
APPO = (0.3, *VTRACE, 0.1)  # clip_eps first, kl_coeff last
CASES = {"ppo": None, "impala": 4, "appo": 4, "impala_odd_n": 3}


def _batch(case, seed):
    rng = np.random.default_rng(seed)
    if case == "ppo":
        n = 64
        return {
            "obs": rng.normal(size=(n, OBS)).astype(np.float32),
            "actions": rng.integers(0, ACTS, n).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.2, 0.6, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32),
        }
    T, N = 8, CASES[case]
    return {
        "obs": rng.normal(size=(T, N, OBS)).astype(np.float32),
        "actions": rng.integers(0, ACTS, (T, N)).astype(np.int32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "dones": (rng.random((T, N)) < 0.15).astype(np.float32),
        "logp": np.log(rng.uniform(0.2, 0.6, (T, N))).astype(np.float32),
        "next_obs": rng.normal(size=(N, OBS)).astype(np.float32),
    }


def _learner(case, mesh=None):
    """The port's learner for ``case``, with the loss its algorithm
    builds (IMPALA's and APPO's take the learner's ``dp_mean``)."""
    box = []

    def loss(p, m, b, *extra):
        if case == "ppo":
            return ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01)
        if case == "appo":
            return appo.appo_loss(p, m, b, *extra, *APPO,
                                  dp_mean=box[0].dp_mean)
        return impala.vtrace_loss(p, m, b, *VTRACE, dp_mean=box[0].dp_mean)

    axes = None if case == "ppo" else impala.ROLLOUT_AXES
    box.append(Learner(MLPModule(observation_size=OBS, num_actions=ACTS,
                                 hidden=HIDDEN), loss,
                       make_adam(3e-3, CLIP), mesh=mesh, seed=0,
                       batch_axes=axes))
    return box[0]


def _run(case, weights, target, mesh=None):
    """UPDATES updates of a port learner from ``weights``: (metrics per
    update, final params as numpy)."""
    learner = _learner(case, mesh)
    learner.set_weights(weights)
    learner.opt_state = learner.optimizer.init(learner.params)
    extra = () if target is None else (params_to_torch(target),)
    metrics = [learner.update(_batch(case, 10 + i), *extra)
               for i in range(UPDATES)]
    return metrics, [t.numpy() for t in tree_leaves(learner.params)]


def _worker(rank, world, case, weights, target):
    return _run(case, weights, target,
                make_mesh({"dp": world}, device_type="cpu"))


@pytest.fixture(scope="module", params=list(CASES))
def ref(request):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import make_mesh as ref_make_mesh
    from ray_tpu.rl import appo as j_appo
    from ray_tpu.rl import impala as j_impala
    from ray_tpu.rl import ppo as j_ppo
    from ray_tpu.rl.algorithm import make_adam as j_make_adam
    from ray_tpu.rl.learner import Learner as JLearner
    from ray_tpu.rl.module import MLPModule as JMLP

    case = request.param

    def j_loss(p, m, b, *extra):
        if case == "ppo":
            return j_ppo.ppo_loss(p, m, b, 0.2, 0.5, 0.01)
        if case == "appo":
            return j_appo.appo_loss(p, m, b, *extra, *APPO)
        return j_impala.vtrace_loss(p, m, b, *VTRACE)

    module = JMLP(observation_size=OBS, num_actions=ACTS, hidden=HIDDEN)
    mesh = ref_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    jl = JLearner(module, j_loss, j_make_adam(3e-3, CLIP), mesh=mesh,
                  seed=0)
    weights = jl.get_weights()
    target = None
    extra = ()
    if case == "appo":
        extra = (module.init(jax.random.key(8)),)
        target = jax.tree.map(np.asarray, extra[0])
    metrics = [jl.update({k: jnp.asarray(v)
                          for k, v in _batch(case, 10 + i).items()}, *extra)
               for i in range(UPDATES)]
    return {"case": case, "weights": weights, "target": target,
            "metrics": metrics,
            "params": [np.asarray(x) for x in jax.tree.leaves(jl.params)]}


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    from torch_spawn_util import run_ranks

    return run_ranks(_worker, 2, tmp_path_factory.mktemp("rdzv"),
                     ref["case"], ref["weights"], ref["target"])


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def test_dp_learner_equals_one_learner_on_the_whole_batch(ref, ranks):
    """Both ranks end with the same params, which are one learner's on
    the whole batch; every metric (the shards' mean) is that learner's."""
    one_metrics, one_params = _run(ref["case"], ref["weights"],
                                   ref["target"])
    for metrics, params in ranks:
        for i, (got, want) in enumerate(zip(metrics, one_metrics)):
            assert set(got) == set(want)
            for k in want:
                _close(got[k], want[k], f"update {i} {k}")
        for a, b in zip(params, one_params):
            _close(a, b, "params")
    assert one_metrics[0]["grad_norm"] >= CLIP  # the clip acted


def test_dp_learner_equals_the_reference_dp_learner(ref, ranks):
    metrics, params = ranks[0]
    for i, (got, want) in enumerate(zip(metrics, ref["metrics"])):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"update {i} {k}")
    for a, b in zip(params, ref["params"]):
        _close(a, b, "params")
