"""joblib backend: scikit-learn-style `Parallel` fan-out over the
cluster (reference: python/ray/util/joblib/ — register_ray registers a
ray backend so `with parallel_backend("ray"):` runs joblib workloads on
the cluster).

Usage::

    import joblib
    from ray_tpu_torch.util.joblib import register_ray_tpu

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch"):
        joblib.Parallel()(joblib.delayed(f)(x) for x in data)
"""

from __future__ import annotations

from joblib._parallel_backends import ParallelBackendBase


class _Result:
    """joblib future shim over an ObjectRef: task errors surface here,
    at retrieval (this backend has supports_retrieve_callback=False, so
    joblib's completion callback is dispatch bookkeeping only)."""

    def __init__(self, ref, on_done=None):
        self._ref = ref
        self._on_done = on_done

    def get(self, timeout=None):
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            out = ray_tpu_torch.get(self._ref, timeout=timeout)
        except GetTimeoutError:
            # Still running: keep it in the backend's inflight set so a
            # following abort_everything can cancel it.
            raise
        except Exception:
            self._done()
            raise
        self._done()
        return out

    def _done(self):
        if self._on_done is not None:
            self._on_done()
            self._on_done = None


class RayTpuBackend(ParallelBackendBase):
    """Each joblib batch becomes one cluster task."""

    supports_timeout = True

    def __init__(self, **kwargs):
        # joblib batches callables itself; nested parallelism inside a
        # worker falls back to sequential/threading (nesting_level must
        # reach the base class or get_nested_backend computes None + 1).
        kwargs.setdefault("nesting_level", 0)
        super().__init__(**kwargs)
        self._task = None
        # Refs still outstanding (pruned on completion so an abort near
        # the end of a long run cancels only live batches).
        self._inflight: set = set()

    def effective_n_jobs(self, n_jobs):
        import ray_tpu_torch

        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        total_cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if n_jobs is None:
            return max(total_cpus, 1)
        if n_jobs < 0:  # -1 = all cluster CPUs, -2 = all but one, ...
            return max(total_cpus + 1 + n_jobs, 1)
        return n_jobs

    def configure(self, n_jobs=1, parallel=None, **kwargs):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()

        @ray_tpu_torch.remote
        def _run_joblib_batch(batch):
            return batch()

        self._task = _run_joblib_batch
        self._inflight.clear()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def apply_async(self, func, callback=None):
        ref = self._task.remote(func)
        self._inflight.add(ref)
        result = _Result(ref, on_done=lambda: self._inflight.discard(ref))
        if callback is not None:
            # Without retrieve-callback support the callback is pure
            # dispatch bookkeeping (BatchCompletionCallBack.__call__ →
            # _dispatch_new) and must fire on success AND failure —
            # errors surface later via get() in ordered retrieval, so
            # the waiter swallows them (no spurious thread tracebacks).
            import threading

            def wait():
                try:
                    result.get()
                # tpulint: allow(broad-except reason=joblib surfaces task errors at ordered retrieval via get(); the waiter only drives dispatch bookkeeping and a traceback here would be a duplicate)
                except Exception:  # noqa: BLE001 - re-raised at retrieval
                    pass
                finally:
                    callback(result)

            threading.Thread(target=wait, daemon=True).start()
        return result

    def submit(self, func, callback=None):
        # joblib >= 1.4 name for apply_async.
        return self.apply_async(func, callback)

    def abort_everything(self, ensure_ready=True):
        # Best-effort cancel of every outstanding batch (queued batches
        # fail fast; running ones are force-killed and their workers
        # replaced).
        import ray_tpu_torch

        # Snapshot: completion callbacks discard from the set
        # concurrently (daemon wait threads).
        for ref in list(self._inflight):
            try:
                ray_tpu_torch.cancel(ref)
            # tpulint: allow(broad-except reason=abort is best-effort over a racing inflight set; a ref that finished or was already cancelled needs no action)
            except Exception:  # noqa: BLE001 - already finished etc.
                pass
        self._inflight.clear()
        self._task = None
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)


def register_ray_tpu() -> None:
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
