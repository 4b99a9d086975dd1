"""Serve integration: an LLM deployment wrapping the engine.

Reference shape: ray.llm builds Serve deployments around vLLM engines
(reference: python/ray/llm/_internal/serve/, serve/llm/). Here the replica
owns an LLMEngine; requests are enqueued into the engine's continuous
batcher and a single background pump drives step() while any request is
in flight, so concurrent callers share decode batches instead of queueing
behind each other.
"""

from __future__ import annotations

import asyncio
import time

from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import ByteTokenizer


class LLMServer:
    """Deployment callable. Use via build_llm_deployment()."""

    def __init__(self, model="tiny", engine_kwargs=None, tokenizer=None):
        self.engine = LLMEngine(model, **(engine_kwargs or {}))
        self.tokenizer = tokenizer or ByteTokenizer()
        self._waiters: dict[str, asyncio.Future] = {}
        # request_id → queue of token-delta lists; None marks the end of
        # a stream (the feed for SSE streaming responses).
        self._streams: dict[str, asyncio.Queue] = {}
        # request_id → engine timing of a finished streamed request
        # (the pump parks it here; stream() reads it after the None
        # sentinel to emit the prefill/decode spans).
        self._timings: dict[str, dict] = {}
        self._pump_task: asyncio.Task | None = None
        # Deployment label for telemetry: replicas learn their own name
        # from the first request's context (the engine pump itself runs
        # outside any request).
        self._deployment = "llm"

    def _note_deployment(self) -> str:
        from ray_tpu_torch.serve.context import get_request_context

        dep = get_request_context().deployment
        if dep:
            self._deployment = dep
        return self._deployment

    async def _pump(self):
        from ray_tpu_torch.serve import telemetry as stel

        loop = asyncio.get_running_loop()
        tel_on = stel.enabled()
        try:
            while self.engine.has_unfinished():
                # step() is blocking JAX compute (seconds on a first
                # compile) — run it off-loop so this replica keeps
                # answering RPCs, including the controller's health polls.
                finished = await loop.run_in_executor(None, self.engine.step)
                for rid, toks in self.engine.drain_deltas().items():
                    q = self._streams.get(rid)
                    if q is not None:
                        q.put_nowait(toks)
                for fin in finished:
                    fut = self._waiters.pop(fin["request_id"], None)
                    if fut is not None and not fut.done():
                        fut.set_result(fin)
                    q = self._streams.get(fin["request_id"])
                    if q is not None:
                        self._timings[fin["request_id"]] = fin
                        q.put_nowait(None)
                if tel_on:
                    # Saturation gauges at step cadence: decode-slot
                    # occupancy + paged-KV pool utilization — the
                    # engine-side signals the SLO autoscaler reads.
                    eng = self.engine
                    stel.set_engine_gauges(
                        self._deployment,
                        active=len(eng._active),
                        max_batch=eng.max_batch,
                        pages_free=(
                            eng.alloc.free_pages
                            if eng.kv == "paged" else None
                        ),
                        pages_total=(
                            eng.alloc.num_pages
                            if eng.kv == "paged" else None
                        ),
                    )
        # tpulint: allow(broad-except reason=the pump failure is fanned out to every pending waiter future and stream queue - nothing is swallowed)
        except Exception as e:  # noqa: BLE001
            # Fail every pending caller rather than hanging them forever.
            waiters, self._waiters = self._waiters, {}
            for fut in waiters.values():
                if not fut.done():
                    fut.set_exception(e)
            streams, self._streams = self._streams, {}
            for q in streams.values():
                q.put_nowait(e)

    def _ensure_pump(self):
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = asyncio.ensure_future(self._pump())

    async def generate(
        self,
        prompt: str | list[int],
        max_tokens: int = 64,
        temperature: float = 0.0,
        stop_token_ids: tuple = (),
    ) -> dict:
        tokens = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
        )
        sampling = SamplingParams(
            max_tokens=max_tokens,
            temperature=temperature,
            stop_token_ids=tuple(stop_token_ids),
        )
        from ray_tpu_torch.serve import telemetry as stel

        deployment = self._note_deployment()
        rid = self.engine.add_request(tokens, sampling)
        fut = asyncio.get_running_loop().create_future()
        self._waiters[rid] = fut
        self._ensure_pump()
        fin = await fut
        out = fin["tokens"]
        timing = fin.get("timing") or {}
        if stel.enabled():
            # serve:prefill / serve:decode under this request's replica
            # span (the contextvar survives the await — same task).
            stel.record_engine_phases(deployment, timing, len(out))
        return {
            "tokens": out,
            "text": self.tokenizer.decode(out),
            "num_generated": len(out),
            "ttft_s": timing.get("ttft_s"),
        }

    async def stream(
        self,
        prompt: str | list[int],
        max_tokens: int = 64,
        temperature: float = 0.0,
        stop_token_ids: tuple = (),
    ):
        """Async generator: yields one dict per decode-step delta as the
        engine produces tokens (reference: ray.llm streaming chat
        completions over vLLM's AsyncLLMEngine generator)."""
        tokens = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
        )
        sampling = SamplingParams(
            max_tokens=max_tokens,
            temperature=temperature,
            stop_token_ids=tuple(stop_token_ids),
        )
        from ray_tpu_torch.serve import telemetry as stel

        deployment = self._note_deployment()
        tel_on = stel.enabled()
        rid = self.engine.add_request(tokens, sampling, stream=True)
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        self._ensure_pump()
        produced = 0
        last_ts = time.time()
        try:
            while True:
                delta = await q.get()
                if delta is None:
                    break
                if isinstance(delta, BaseException):
                    raise delta
                produced += len(delta)
                if tel_on:
                    # Per-delta decode spans ride the high-rate sampler
                    # so a long generation can't storm the recorder.
                    now = time.time()
                    stel.record_token_span(
                        deployment, last_ts, now - last_ts, len(delta)
                    )
                    last_ts = now
                yield {
                    "tokens": delta,
                    "text": self.tokenizer.decode(delta),
                    "num_generated": produced,
                }
        finally:
            fin = self._timings.pop(rid, None)
            if tel_on and fin is not None:
                stel.record_engine_phases(
                    deployment, fin.get("timing"), produced
                )
            self._streams.pop(rid, None)
            # Client gone (or stream complete — then this is a no-op):
            # free the engine slot instead of decoding to max_tokens for
            # nobody.
            self.engine.abort_request(rid)

    async def stats(self) -> dict:
        """Engine serving counters (reference shape: the vLLM metrics
        ray.llm deployments expose) — callable as a deployment method:
        HTTP {"method": "stats"} or handle.options(method_name=
        "stats"). Async via the executor: engine.stats() takes the
        engine lock, which the pump holds across whole step() calls —
        grabbing it on the event loop would freeze the replica for a
        step (minutes on a first compile)."""
        return await asyncio.get_running_loop().run_in_executor(
            None, self.engine.stats
        )

    async def __call__(self, request: dict):
        body = request.get("body") if isinstance(request, dict) else None
        if isinstance(body, dict):
            # HTTP ingress shape: parameters ride in the JSON body.
            request = body
        if request.get("method") == "stats":
            return await self.stats()
        if request.get("stream"):
            return self.stream(
                request["prompt"],
                max_tokens=request.get("max_tokens", 64),
                temperature=request.get("temperature", 0.0),
            )
        return await self.generate(
            request["prompt"],
            max_tokens=request.get("max_tokens", 64),
            temperature=request.get("temperature", 0.0),
        )


def build_llm_deployment(
    model="tiny",
    *,
    num_replicas: int = 1,
    engine_kwargs: dict | None = None,
    tokenizer=None,
    ray_actor_options: dict | None = None,
):
    """Returns a bound serve deployment; pass to serve.run()."""
    from ray_tpu_torch import serve

    dep = serve.deployment(
        LLMServer,
        num_replicas=num_replicas,
        ray_actor_options=ray_actor_options or {},
        max_ongoing_requests=32,
    )
    return dep.bind(model, engine_kwargs, tokenizer)
