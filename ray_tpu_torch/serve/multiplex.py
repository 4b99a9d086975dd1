"""@serve.multiplexed: many models per replica with LRU eviction.

(reference: python/ray/serve/multiplex.py _ModelMultiplexWrapper — a
replica lazily loads models by id, keeps up to max_num_models_per_replica
with LRU eviction; the router favors replicas with the model warm.)
"""

from __future__ import annotations

import collections
import functools
import inspect

from ray_tpu_torch._private.sanitize import maybe_async_lock


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    def deco(fn):
        if not inspect.iscoroutinefunction(fn):
            raise TypeError("@serve.multiplexed requires an async function")
        attr = f"__serve_mux_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, model_id: str):
            state = getattr(self, attr, None)
            if state is None:
                state = {
                    "models": collections.OrderedDict(),
                    "locks": {},
                }
                setattr(self, attr, state)
            models = state["models"]
            if model_id in models:
                models.move_to_end(model_id)
                return models[model_id]
            # Instrumented under RAY_TPU_SANITIZE=1: the model-load
            # lock joins the sanitizer's global order graph, so an
            # inversion against any other serve/control-plane lock
            # raises at acquisition (TPU203's runtime twin).
            lock = state["locks"].setdefault(
                model_id, maybe_async_lock(
                    f"serve.multiplex.{fn.__name__}.{model_id}"))
            async with lock:
                if model_id in models:  # raced with another loader
                    models.move_to_end(model_id)
                    return models[model_id]
                while len(models) >= max_num_models_per_replica:
                    evicted_id, _evicted = models.popitem(last=False)
                    state["locks"].pop(evicted_id, None)
                model = await fn(self, model_id)
                models[model_id] = model
                return model

        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
