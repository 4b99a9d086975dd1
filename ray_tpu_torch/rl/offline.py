"""Offline RL as a DATA pipeline: episode recording to parquet,
dataset-fed behavior cloning, and offline evaluation.

Reference: rllib/offline/offline_data.py — the reference records
rollouts as episode files, reads them back through Ray Data
(sampling/shuffling handled by the dataset layer, not the algorithm),
and evaluates offline-trained policies. Here (port of
ray_tpu/rl/offline.py: only the evaluation's forward changed, to torch on
the CPU, and the learner takes the config's device) the same three pieces
ride ``ray_tpu_torch.data``: :func:`record_rollouts` writes transition
rows through ``Dataset.write_parquet``; :class:`OfflineBCConfig` trains BC
from those files via ``read_parquet`` + shuffled windowed
``iter_batches``; :func:`evaluate_policy` rolls the cloned policy in a
live env and reports it against the dataset's own behavior returns.

Episode schema (one row per transition, flat columns so parquet stays
columnar): eps_id, t, obs (float list), action, reward, done.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.env import make_env


def record_rollouts(
    algo: Algorithm, path: str, *, num_rounds: int = 1
) -> dict:
    """Sample the algorithm's env runners ``num_rounds`` times and
    write every transition to parquet under ``path`` (the recording
    half of the reference's offline_data pipeline). Returns a summary
    {rows, episodes, mean_episode_return}."""
    import ray_tpu_torch.data as rdata

    rows: list[dict] = []
    eps_counter = 0
    ep_returns: list[float] = []
    for _ in range(num_rounds):
        algo.runners.set_weights(algo.learner.get_weights())
        for sample in algo.runners.sample():
            obs = sample["obs"]  # [T, N, D]
            acts = sample["actions"]
            rews = sample["rewards"]
            dones = sample["dones"]
            T, N = acts.shape[:2]
            # Per env-slot episode ids: a done splits episodes.
            for n in range(N):
                eps_id = eps_counter
                eps_counter += 1
                t_in_ep = 0
                ep_ret = 0.0
                for t in range(T):
                    rows.append(
                        {
                            "eps_id": int(eps_id),
                            "t": int(t_in_ep),
                            "obs": [float(x) for x in obs[t, n]],
                            "action": int(acts[t, n]),
                            "reward": float(rews[t, n]),
                            "done": bool(dones[t, n]),
                        }
                    )
                    ep_ret += float(rews[t, n])
                    t_in_ep += 1
                    if dones[t, n]:
                        ep_returns.append(ep_ret)
                        ep_ret = 0.0
                        eps_id = eps_counter
                        eps_counter += 1
                        t_in_ep = 0
    ds = rdata.from_items(rows)
    ds.write_parquet(path)
    return {
        "rows": len(rows),
        "episodes": len(ep_returns),
        "mean_episode_return": (
            float(np.mean(ep_returns)) if ep_returns else float("nan")
        ),
    }


def dataset_report(path: str) -> dict:
    """Behavior statistics of a recorded dataset (the baseline an
    offline-trained policy is judged against)."""
    import ray_tpu_torch.data as rdata

    ds = rdata.read_parquet(path)
    n = ds.count()
    # Episode returns: sum rewards per eps_id.
    returns = [
        row["sum(reward)"]
        for row in ds.groupby("eps_id").sum("reward").take_all()
    ]
    completed = ds.filter(lambda r: r["done"]).count()
    return {
        "rows": n,
        "episodes_started": len(returns),
        "episodes_completed": completed,
        "behavior_return_mean": float(np.mean(returns)),
    }


def evaluate_policy(
    module, params, env_name: str, *, env_kwargs=None,
    n_episodes: int = 20, max_steps: int = 200, seed: int = 0,
    greedy: bool = True,
) -> dict:
    """Roll the policy in a live env (the online half of offline
    evaluation; reference: offline RL evaluation rollouts)."""
    from ray_tpu_torch.rl.env_runner import _cpu_forward
    from ray_tpu_torch.rl.module import params_to_torch

    fwd = _cpu_forward(module)
    params = params_to_torch(params)  # a CPU copy of the learner's
    rng = np.random.default_rng(seed)
    returns = []
    for ep in range(n_episodes):
        env = make_env(env_name, **(env_kwargs or {}))
        obs = env.reset(seed + ep)
        total = 0.0
        for _ in range(max_steps):
            out = fwd(params, obs[None])
            logits = np.asarray(out["logits"])[0]
            if greedy:
                a = int(logits.argmax())
            else:
                z = logits - logits.max()
                p = np.exp(z) / np.exp(z).sum()
                a = int(rng.choice(len(p), p=p))
            obs, r, done = env.step(a)
            total += float(r)
            if done:
                break
        returns.append(total)
    return {
        "episodes": n_episodes,
        "return_mean": float(np.mean(returns)),
        "return_min": float(np.min(returns)),
        "return_max": float(np.max(returns)),
    }


from ray_tpu_torch.rl.bc import BCConfig  # noqa: E402


@dataclass(frozen=True)
class OfflineBCConfig(BCConfig):
    """BC fed from recorded parquet episodes through ray_tpu_torch.data
    (reference: BC with input_=dataset paths via offline_data.py).
    ``input_path`` replaces the in-memory ``dataset`` dict; each
    epoch re-shuffles the dataset and iterates windowed batches."""

    input_path: str = ""
    shuffle_seed: int = 0

    def build(self) -> "OfflineBC":
        return OfflineBC(self)


class OfflineBC:
    """Dataset-driven BC: the training loop pulls shuffled windowed
    batches from the data pipeline instead of indexing a numpy dict."""

    def __init__(self, config: OfflineBCConfig):
        if not config.input_path:
            raise ValueError("OfflineBCConfig.input_path is required")
        import ray_tpu_torch.data as rdata

        from ray_tpu_torch.rl.algorithm import make_adam
        from ray_tpu_torch.rl.bc import bc_loss
        from ray_tpu_torch.rl.learner import Learner
        from ray_tpu_torch.rl.module import MLPModule

        self.config = config
        self._ds = rdata.read_parquet(config.input_path)
        probe = self._ds.take(1)[0]
        obs_size = len(probe["obs"])
        num_actions = (
            int(
                self._ds.max("action")
            )
            + 1
        )
        self.module = MLPModule(
            observation_size=obs_size, num_actions=num_actions
        )
        self.learner = Learner(
            self.module, bc_loss, make_adam(config.lr),
            mesh=config.mesh, seed=config.seed, device=config.device,
        )
        self.iteration = 0
        self._epoch = 0
        self._batches = self._epoch_batches()

    def _epoch_batches(self):
        """One epoch: reshuffle (a fresh seed per epoch) and iterate
        windowed batches — the dataset layer does the shuffling, the
        algorithm just consumes (reference: offline_data windowed
        iteration)."""
        self._epoch += 1
        return self._ds.random_shuffle(
            seed=self.config.shuffle_seed + self._epoch
        ).iter_batches(
            batch_size=self.config.batch_size, batch_format="numpy"
        )

    def _next_batch(self) -> dict:
        while True:
            batch = next(self._batches, None)
            if batch is not None:
                return batch
            self._batches = self._epoch_batches()

    def train(self) -> dict:
        cfg = self.config
        metrics: dict = {}
        for _ in range(cfg.updates_per_step):
            b = self._next_batch()
            obs = np.stack([np.asarray(o, np.float32) for o in b["obs"]])
            metrics = self.learner.update(
                {
                    "obs": obs,
                    "actions": np.asarray(b["action"], np.int64),
                }
            )
        self.iteration += 1
        metrics["epoch"] = self._epoch
        return {
            k: float(v) if hasattr(v, "item") else v
            for k, v in metrics.items()
        }

    def get_policy(self):
        return self.module, self.learner.params
