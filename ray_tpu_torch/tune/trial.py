"""Trial model + the actor that hosts one trial.

Mirrors the reference's Trial/trainable split (reference:
python/ray/tune/experiment/trial.py Trial states; trainable API
python/ray/tune/trainable/ — function trainables report via session,
class trainables implement step/save/restore). The trial actor runs
function trainables on a private thread so the controller can poll and
stop them through ordinary actor calls.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
import traceback
from typing import Any, Callable

import ray_tpu_torch

logger = logging.getLogger("ray_tpu_torch.tune")

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: dict, local_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.local_dir = local_dir
        self.status = PENDING
        self.results: list[dict] = []
        self.last_result: dict = {}
        self.checkpoint: str | None = None
        self.error: str | None = None
        self.actor = None
        self.is_class_api = False
        self.iteration = 0
        # Infra-failure retry counter (budgeted by TUNE_INFRA_RETRIES;
        # preemptions restart for free and don't consume it).
        self.infra_retries = 0

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, iters={self.iteration})"


class Trainable:
    """Class-API trainable (reference: tune/trainable/trainable.py):
    subclass and implement setup/step/save_checkpoint/load_checkpoint."""

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass


class StopTrial(Exception):
    pass


class _FnSession:
    """In-actor session for function trainables: buffers reports, carries
    the stop flag the controller sets (reference: tune function API
    session + StopTrial semantics)."""

    def __init__(self, trial_dir: str):
        self.lock = threading.Lock()
        self.reports: list[dict] = []
        self.stop = False
        self.trial_dir = trial_dir
        self.n_ckpt = 0
        self.latest_checkpoint: str | None = None

    def report(self, metrics: dict, checkpoint: str | None = None):
        with self.lock:
            if self.stop:
                raise StopTrial()
            entry = {"metrics": dict(metrics)}
            if checkpoint is not None:
                dst = os.path.join(self.trial_dir, f"checkpoint_{self.n_ckpt:06d}")
                self.n_ckpt += 1
                shutil.copytree(checkpoint, dst, dirs_exist_ok=True)
                entry["checkpoint"] = dst
                self.latest_checkpoint = dst
            self.reports.append(entry)


@ray_tpu_torch.remote
class TrialActor:
    """Hosts one trial (reference: tune trials are remote trainable
    actors driven by TuneController)."""

    def __init__(self, trial_dir: str):
        os.makedirs(trial_dir, exist_ok=True)
        self.trial_dir = trial_dir
        self.session = _FnSession(trial_dir)
        self.thread: threading.Thread | None = None
        self.done = False
        self.error: str | None = None
        self.instance: Trainable | None = None
        self.iteration = 0

    # ------------------------------------------------- function API path
    def start_fn(self, fn: Callable, config: dict, restore: str | None = None):
        import ray_tpu_torch.tune as tune_mod

        self.session.latest_checkpoint = restore

        def run():
            tune_mod._set_session(self.session)
            try:
                fn(dict(config))
            except StopTrial:
                pass
            except Exception:  # noqa: BLE001 - reported via poll
                self.error = traceback.format_exc()
                logger.warning("trial failed:\n%s", self.error)
            finally:
                self.done = True
                tune_mod._set_session(None)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        return True

    def poll(self):
        with self.session.lock:
            reports = self.session.reports
            self.session.reports = []
        return {
            "reports": reports,
            "done": self.done,
            "error": self.error,
            "checkpoint": self.session.latest_checkpoint,
        }

    def stop_fn(self):
        with self.session.lock:
            self.session.stop = True
        return True

    # ---------------------------------------------------- class API path
    def setup_class(self, cls: type, config: dict, restore: str | None = None):
        self.instance = cls()
        self.instance.setup(dict(config))
        if restore:
            self.instance.load_checkpoint(restore)
        return True

    def train_step(self):
        assert self.instance is not None
        self.iteration += 1
        metrics = self.instance.step()
        metrics.setdefault("training_iteration", self.iteration)
        return metrics

    def save(self):
        assert self.instance is not None
        d = os.path.join(self.trial_dir, f"checkpoint_{self.iteration:06d}")
        os.makedirs(d, exist_ok=True)
        self.instance.save_checkpoint(d)
        return d

    def restore(self, checkpoint_dir: str, config: dict | None = None,
                iteration: int | None = None):
        assert self.instance is not None
        if config is not None:
            self.instance.setup(dict(config))
        self.instance.load_checkpoint(checkpoint_dir)
        if iteration is not None:
            self.iteration = iteration
        return True

    def shutdown(self):
        if self.instance is not None:
            self.instance.cleanup()
        return True
