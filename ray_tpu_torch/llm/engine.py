"""LLMEngine: continuous batching over the prefill/decode programs (port
of ray_tpu/llm/engine.py).

Slot model: the KV cache holds ``max_batch`` rows. add_request() parks
requests in a FIFO; step() admits queued requests into free slots (one
prefill each, bucketed to power-of-two lengths) and then advances every
active slot with one decode step.

On a CUDA device the paged engine reads its pool through the paged
attention kernel and the dense engine prefills through the flash kernel
(for lengths the gate admits); on the CPU both take their plain PyTorch
versions. ``RAY_TPU_PAGED_ATTN`` read at construction overrides the
paged route on any device: ``0`` decodes and verifies through the gather
path (``paged_kv._gather_page_attention``), ``1`` through the wrapper;
``paged_attn_kernel`` reports the route taken. Sampling draws from a
``torch.Generator`` on the engine's device, seeded from ``seed``.

With ``mesh=`` (parallel/mesh.py, more than one rank) the engine is
tensor-parallel SPMD, one process per device: every rank builds the same
engine and calls the same methods in the same order. The parameters are
placed by ``param_logical_axes`` and each rank keeps what it computes
with (its heads, FFN columns and vocabulary rows over tp, everything
gathered over the other axes); the KV cache or paged pool holds the
rank's KV heads when tp divides them, else all of them. The paged kernel
and the flash prefill run on each rank's heads. The logits are gathered
over tp before sampling and every rank's generator has the same seed, so
each rank samples the same token: a rank that sampled another would
wait forever at the next collective.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ray_tpu_torch import mesh_size, resolve_device
from ray_tpu_torch.llm.kv_cache import (
    forward_decode,
    forward_prefill,
    init_kv_cache,
)
from ray_tpu_torch.llm.paged_kv import (
    PageAllocator,
    init_paged_kv,
    paged_decode,
    paged_prefill,
    paged_prefill_chunk,
    paged_verify,
    prefix_hashes,
    propose_ngram_draft,
)
from ray_tpu_torch.models.llama import (
    PRESETS,
    LlamaConfig,
    init_params,
    param_logical_axes,
    use_params,
)
from ray_tpu_torch.parallel.sharding import shard_pytree, use_mesh


@dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = full vocab
    stop_token_ids: tuple = ()
    seed: int = 0


@dataclass
class _Request:
    request_id: str
    prompt: list[int]
    sampling: SamplingParams
    out_tokens: list = field(default_factory=list)
    slot: int = -1
    position: int = 0  # index the NEXT token will be written at
    last_token: int = 0
    done: bool = False
    pages: list = field(default_factory=list)  # paged mode: block table
    # Wall-clock timing; first-write-wins so a preemption's recompute
    # re-admission never resets TTFT.
    submit_ts: float = 0.0
    prefill_start_ts: float = 0.0
    first_token_ts: float = 0.0
    finish_ts: float = 0.0


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class LLMEngine:
    def __init__(
        self,
        model: str | LlamaConfig = "tiny",
        *,
        max_batch: int = 4,
        max_seq: int | None = None,
        mesh=None,
        params=None,
        seed: int = 0,
        kv: str = "paged",  # "paged" (block-table pool) | "dense" (slab)
        page_size: int = 64,
        num_pages: int | None = None,
        speculate: int = 0,  # draft tokens per step (prompt lookup)
        prefill_chunk: int | None = None,  # tokens per prefill chunk
        prefill_delay_s: float = 0.0,  # chaos: injected TTFT (tests)
        device: str | torch.device = "cuda",
    ):
        cfg = PRESETS[model] if isinstance(model, str) else model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq
        if params is None:
            params = init_params(
                cfg, seed, device=self.device, dtype=cfg.dtype
            )
        self.mesh = mesh if mesh_size(mesh) > 1 else None
        if self.mesh is not None:
            axes = param_logical_axes(cfg)
            with torch.no_grad():
                params = use_params(shard_pytree(params, mesh, axes), axes,
                                    cfg, mesh)
        self.params = params
        if kv not in ("paged", "dense"):
            raise ValueError(f"kv must be 'paged' or 'dense', got {kv!r}")
        self.kv = kv
        self.page_size = page_size
        self.prefill_delay_s = float(prefill_delay_s)
        on_cuda = self.device.type == "cuda"
        if speculate and kv != "paged":
            raise ValueError("speculative decoding needs kv='paged'")
        if prefill_chunk is not None and kv != "paged":
            raise ValueError("chunked prefill needs kv='paged'")
        self.speculate = int(speculate)
        if kv == "paged":
            # Default token budget matches the dense slab; serving
            # deployments pass a smaller num_pages for memory-bound
            # admission.
            if num_pages is None:
                num_pages = max(
                    (max_batch * self.max_seq) // page_size, max_batch
                )
            self.alloc = PageAllocator(num_pages, page_size)
            # +1: physical page 0 is the allocator's dump page.
            self.cache = init_paged_kv(
                cfg, num_pages + 1, page_size, device=self.device,
                mesh=self.mesh,
            )
            self.max_pages_per_seq = -(-self.max_seq // page_size)
            # The kernel on CUDA, the gather path on the CPU, unless
            # RAY_TPU_PAGED_ATTN says 0 (gather) or 1 (the wrapper: on the
            # CPU its plain version).
            # tpulint: allow(TPU703 reason=emergency kernel off-switch read in library code that must work without a live runtime or config registry)
            env_flag = os.environ.get("RAY_TPU_PAGED_ATTN", "").strip()
            if env_flag in ("0", "1"):
                use_kernel = env_flag == "1"
            else:
                use_kernel = on_cuda
            self.paged_attn_kernel = use_kernel
            # Chunked prefill: a prompt longer than the chunk is
            # prefilled one page-aligned chunk per step(), interleaved
            # with decode.
            if prefill_chunk is not None:
                prefill_chunk = max(
                    -(-prefill_chunk // page_size) * page_size, page_size
                )
            self.prefill_chunk = prefill_chunk
            self._prefilling: dict | None = None
            self._prefill_chunk_fn = partial(paged_prefill_chunk, cfg=cfg)
            self._prefill_paged = partial(paged_prefill, cfg=cfg)
            self._decode_paged = partial(
                paged_decode, cfg=cfg, use_kernel=use_kernel
            )
            self._verify_paged = partial(
                paged_verify, cfg=cfg, use_kernel=use_kernel
            )
            self._temps = np.zeros((max_batch,), np.float32)
        else:
            self.prefill_chunk = None
            self._prefilling = None
            self.cache = init_kv_cache(
                cfg, max_batch, self.max_seq, device=self.device,
                mesh=self.mesh,
            )
            self._prefill = partial(
                forward_prefill, cfg=cfg, use_flash=on_cuda
            )
            self._decode = partial(forward_decode, cfg=cfg)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: list[_Request] = []
        self._active: dict[int, _Request] = {}  # slot -> request
        self._free = list(range(max_batch))
        self._ids = itertools.count()
        self._rng = np.random.default_rng(seed)
        # Host mirrors of the decode inputs, one entry per slot.
        self._tokens = np.zeros((max_batch, 1), np.int32)
        self._positions = np.zeros((max_batch,), np.int32)
        # add_request may run on another thread than step().
        self._lock = threading.Lock()
        # Tokens emitted since the last drain_deltas(), for requests added
        # with stream=True.
        self._deltas: dict[str, list[int]] = {}
        self._stream_ids: set[str] = set()
        self._stats = {
            "requests_submitted": 0,
            "requests_finished": 0,
            "tokens_generated": 0,
            "draft_tokens_proposed": 0,
            "draft_tokens_accepted": 0,
            "requests_aborted": 0,
            "preemptions": 0,
            "prefill_chunks": 0,
            "decode_steps": 0,
        }

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array copied to the engine's device."""
        return torch.tensor(arr, device=self.device)

    # ------------------------------------------------------ request API
    def add_request(
        self,
        prompt: list[int],
        sampling: SamplingParams | None = None,
        request_id: str | None = None,
        stream: bool = False,
    ) -> str:
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq {self.max_seq}"
            )
        sampling = sampling or SamplingParams()
        if self.kv == "paged":
            # Reject requests the pool could never hold (prompt plus its
            # full max_tokens growth) at submission.
            P = self.page_size
            worst = min(len(prompt) + sampling.max_tokens, self.max_seq)
            pad = min(max(_bucket(worst), P), self.max_pages_per_seq * P)
            if pad // P > self.alloc.num_pages:
                raise ValueError(
                    f"prompt+max_tokens needs {pad // P} pages but the "
                    f"pool holds {self.alloc.num_pages}; raise num_pages "
                    "or lower max_tokens"
                )
        rid = request_id or f"req-{next(self._ids)}"
        with self._lock:
            self._stats["requests_submitted"] += 1
            if stream:
                self._stream_ids.add(rid)
            self._queue.append(
                _Request(rid, list(prompt), sampling, submit_ts=time.time())
            )
        return rid

    def _begin_prefill(self, req: _Request) -> None:
        """Mark prefill start (first-write-wins) and apply the injected
        prefill delay (the ``prefill_delay_s`` engine kwarg, or the
        RAY_TPU_LLM_PREFILL_DELAY env knob) — a deterministic TTFT
        injection."""
        if req.prefill_start_ts == 0.0:
            req.prefill_start_ts = time.time()
        delay = self.prefill_delay_s
        if delay <= 0:
            from ray_tpu_torch._private import config

            delay = config.get("LLM_PREFILL_DELAY")
        if delay > 0:
            time.sleep(delay)

    def has_unfinished(self) -> bool:
        return bool(
            self._queue or self._active or self._prefilling is not None
        )

    def _sample(self, logits: np.ndarray, s: SamplingParams) -> int:
        if s.temperature <= 0.0:
            return int(logits.argmax())
        logits = logits / s.temperature
        if s.top_k:
            kth = np.partition(logits, -s.top_k)[-s.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        logits = logits - logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        return int(self._rng.choice(len(probs), p=probs))

    def _finish_if_done(self, req: _Request, finished: list[dict]) -> bool:
        """Evaluate stop conditions on req's latest token."""
        s = req.sampling
        tok = req.out_tokens[-1]
        if not (
            tok in s.stop_token_ids
            or len(req.out_tokens) >= s.max_tokens
            or req.position >= self.max_seq - 1
        ):
            return False
        if tok in s.stop_token_ids:
            req.out_tokens.pop()  # don't return the stop token
            d = self._deltas.get(req.request_id)
            if d and d[-1] == tok:
                d.pop()
        req.done = True
        req.finish_ts = time.time()
        self._stats["requests_finished"] += 1
        self._stream_ids.discard(req.request_id)
        finished.append(
            {
                "request_id": req.request_id,
                "prompt": req.prompt,
                "tokens": req.out_tokens,
                "timing": self._request_timing(req),
            }
        )
        if req.slot in self._active:
            del self._active[req.slot]
            self._free.append(req.slot)
        self._release_pages(req)
        return True

    @staticmethod
    def _request_timing(req: _Request) -> dict:
        """Wall-clock phases of one finished request: queue, prefill,
        decode, and TTFT."""
        t = {
            "submit_ts": req.submit_ts,
            "prefill_start_ts": req.prefill_start_ts,
            "first_token_ts": req.first_token_ts,
            "finish_ts": req.finish_ts,
        }
        if req.submit_ts and req.prefill_start_ts:
            t["queue_s"] = max(0.0, req.prefill_start_ts - req.submit_ts)
        if req.prefill_start_ts and req.first_token_ts:
            t["prefill_s"] = max(
                0.0, req.first_token_ts - req.prefill_start_ts
            )
        if req.submit_ts and req.first_token_ts:
            t["ttft_s"] = max(0.0, req.first_token_ts - req.submit_ts)
        if req.first_token_ts and req.finish_ts:
            t["decode_s"] = max(0.0, req.finish_ts - req.first_token_ts)
        return t

    def _release_pages(self, req: _Request) -> None:
        if self.kv == "paged":
            for pg in req.pages:
                self.alloc.release(pg)
            req.pages = []

    def _admit(self, finished: list[dict]) -> None:
        while self._queue and self._free:
            if self.kv == "paged":
                if not self._admit_one_paged(finished):
                    return
                continue
            req = self._queue.pop(0)
            slot = self._free.pop(0)
            self._begin_prefill(req)
            pad = min(_bucket(len(req.prompt)), self.max_seq)
            tokens = np.zeros((1, pad), np.int32)
            tokens[0, : len(req.prompt)] = req.prompt
            logits, self.cache = self._prefill(
                self.params, self._dev(tokens), self.cache, slot
            )
            self._post_prefill(req, slot, logits, len(req.prompt), finished)

    def _post_prefill(
        self, req, slot, logits, ctx_len, finished, logit_idx=None
    ) -> None:
        """Shared dense/paged tail of admission: sample the next token
        from the context's last logits, activate, run stop checks.
        ``logit_idx`` overrides the row to sample from (chunked prefill:
        the last token's index local to the final chunk)."""
        row = ctx_len - 1 if logit_idx is None else logit_idx
        last = logits[0, row].cpu().numpy()
        req.slot = slot
        req.position = ctx_len
        if req.first_token_ts == 0.0:
            req.first_token_ts = time.time()
        req.last_token = self._sample(last, req.sampling)
        self._stats["tokens_generated"] += 1  # the prefill-sampled token
        req.out_tokens.append(req.last_token)
        if req.request_id in self._stream_ids:
            self._deltas.setdefault(req.request_id, []).append(
                req.last_token
            )
        self._active[slot] = req
        if not self._finish_if_done(req, finished):
            self._tokens[slot, 0] = req.last_token
            self._positions[slot] = req.position
            if self.kv == "paged":
                self._temps[slot] = req.sampling.temperature

    def _admit_one_paged(self, finished: list[dict]) -> bool:
        """Admit the head of the queue if its pages fit the pool
        (memory-bound admission). Returns False when the pool cannot hold
        the next request yet."""
        if self._prefilling is not None:
            # One chunked prefill at a time.
            return False
        P = self.page_size
        req = self._queue[0]
        # Full context: the prompt plus anything generated before a
        # preemption (recompute-style resume).
        context = list(req.prompt) + list(req.out_tokens)
        pad = min(max(_bucket(len(context)), P), self.max_pages_per_seq * P)
        need_pages = pad // P
        # Prefix sharing: leading FULL pages whose token prefix matches a
        # live page are reused (refcounted).
        hashes = prefix_hashes(context, P)
        shared: list[int] = []
        for h in hashes:
            pg = self.alloc.lookup_prefix(h)
            if pg is None:
                break
            shared.append(pg)
        if need_pages > self.alloc.num_pages:
            self._queue.pop(0)
            raise RuntimeError(
                f"prompt needs {need_pages} pages but the pool holds "
                f"{self.alloc.num_pages}; raise num_pages or page_size"
            )
        if need_pages - len(shared) > self.alloc.free_pages:
            return False
        self._queue.pop(0)
        slot = self._free.pop(0)
        self._begin_prefill(req)
        pages = [self.alloc.share(pg) for pg in shared]
        for i in range(len(shared), need_pages):
            pg = self.alloc.alloc()
            if i < len(hashes):
                self.alloc.register_prefix(hashes[i], pg)
            pages.append(pg)
        req.pages = pages
        # Writes for the shared pages go to the dump page 0: a live request
        # reads them, and the same tokens prefilled at another bucket length
        # need not give byte-identical K/V on the card (cuBLAS tiles the two
        # products differently), so a shared page is never rewritten.
        write_pages = np.asarray([0] * len(shared) + pages[len(shared):],
                                 np.int32)
        if (
            self.prefill_chunk is not None
            and len(context) > self.prefill_chunk
        ):
            # Long prompt: hold the slot and prefill one chunk per step().
            self._prefilling = {
                "req": req,
                "slot": slot,
                "context": context,
                "pages": np.asarray(pages, np.int32),
                "write_pages": write_pages,
                "next_start": 0,
                "ctx_pad": -(-len(context) // P) * P,
                "need_pages": need_pages,
            }
            self._prefill_step(finished)
            return True
        tokens = np.zeros((1, pad), np.int32)
        tokens[0, : len(context)] = context
        logits, self.cache = self._prefill_paged(
            self.params,
            self._dev(tokens),
            self.cache,
            self._dev(write_pages),
            n_write_pages=need_pages,
        )
        self._post_prefill(req, slot, logits, len(context), finished)
        return True

    def _prefill_step(self, finished: list[dict]) -> None:
        """Advance the in-flight chunked prefill by ONE chunk; on the
        final chunk, sample the first token and activate the slot."""
        st = self._prefilling
        P = self.page_size
        context = st["context"]
        start = st["next_start"]
        end = min(start + self.prefill_chunk, st["ctx_pad"])
        tokens = np.zeros((1, end - start), np.int32)
        valid = context[start: min(end, len(context))]
        tokens[0, : len(valid)] = valid
        logits, self.cache = self._prefill_chunk_fn(
            self.params,
            self._dev(tokens),
            self.cache,
            self._dev(st["pages"]),
            start,
            n_write_pages=st["need_pages"],
            chunk_pages=(end - start) // P,
            write_pages=self._dev(st["write_pages"]),
        )
        st["next_start"] = end
        self._stats["prefill_chunks"] += 1
        if end >= st["ctx_pad"]:
            self._prefilling = None
            # ctx_len-1 always falls in the final chunk.
            self._post_prefill(
                st["req"], st["slot"], logits, len(context), finished,
                logit_idx=len(context) - 1 - start,
            )

    def _in_mesh(self):
        """The engine's mesh made ambient for the model code (none: a
        no-op)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh(self.mesh)

    def step(self) -> list[dict]:
        """Admit + one decode step. Returns finished request dicts."""
        finished: list[dict] = []
        with self._lock, self._in_mesh():
            if self._prefilling is not None:
                self._prefill_step(finished)
            self._admit(finished)
            if not self._active:
                return finished
            if self.kv == "paged":
                self._step_paged(finished)
                return finished
            logits, self.cache = self._decode(
                self.params,
                self._dev(self._tokens),
                self.cache,
                self._dev(self._positions),
            )
            self._stats["decode_steps"] += 1
            logits = logits.cpu().numpy()
            for slot, req in list(self._active.items()):
                tok = self._sample(logits[slot], req.sampling)
                self._record_token(req, tok, finished)
        return finished

    def _record_token(self, req, tok: int, finished: list[dict]) -> None:
        req.position += 1
        self._stats["tokens_generated"] += 1
        req.out_tokens.append(tok)
        if req.request_id in self._stream_ids:
            self._deltas.setdefault(req.request_id, []).append(tok)
        req.last_token = tok
        self._tokens[req.slot, 0] = tok
        self._positions[req.slot] = req.position
        self._finish_if_done(req, finished)

    def _preempt(self, req: _Request) -> None:
        """Recompute preemption: free the pages and slot and requeue at
        the FRONT; re-admission prefills the full context so generation
        resumes where it stopped. req.prompt is never mutated."""
        self._stats["preemptions"] += 1
        self._release_pages(req)
        if req.slot in self._active:
            del self._active[req.slot]
            self._free.append(req.slot)
        req.slot = -1
        self._queue.insert(0, req)

    def _step_paged(self, finished: list[dict]) -> None:
        P = self.page_size
        K = 1 + self.speculate
        # Grow block tables to cover every position this step may write;
        # an exhausted pool preempts the youngest active request.
        for slot, req in list(self._active.items()):
            if req.slot == -1 or req.done:
                continue
            # Clamped to the table width: near max_seq a K-wide step may
            # reach past capacity; those writes go to the dump page.
            needed = min(
                (req.position + K - 1) // P + 1, self.max_pages_per_seq
            )
            while len(req.pages) < needed and req.slot != -1:
                if self.alloc.free_pages == 0:
                    victims = [
                        r for r in self._active.values() if r is not req
                    ]
                    if not victims:
                        self._preempt(req)
                        break
                    self._preempt(victims[-1])
                else:
                    req.pages.append(self.alloc.alloc())
        if not self._active:
            return

        tables = np.full(
            (self.max_batch, self.max_pages_per_seq), -1, np.int32
        )
        for slot, req in self._active.items():
            tables[slot, : len(req.pages)] = req.pages
        self._stats["decode_steps"] += 1
        if self.speculate:
            self._step_paged_speculative(tables, finished)
            return
        sampled, logits, self.cache = self._decode_paged(
            self.params,
            self._dev(self._tokens),
            self.cache,
            self._dev(tables),
            self._dev(self._positions),
            self._dev(self._temps),
            self._gen,
        )
        sampled = sampled.cpu().numpy()  # [B] ints: the only transfer
        host_logits = None
        for slot, req in list(self._active.items()):
            if req.sampling.top_k and req.sampling.temperature > 0:
                # top-k needs host logic; transfer logits lazily, once.
                if host_logits is None:
                    host_logits = logits.cpu().numpy()
                tok = self._sample(host_logits[slot], req.sampling)
            else:
                tok = int(sampled[slot])
            self._record_token(req, tok, finished)

    def _step_paged_speculative(self, tables, finished) -> None:
        """Prompt-lookup speculative step: verify K = 1 + speculate
        positions per slot in one pass and accept the longest draft
        prefix the model agrees with. Greedy slots accept on argmax
        equality; stochastic slots use exact rejection sampling on the
        device (see paged_kv.paged_verify); top_k slots run with an empty
        draft."""
        K = 1 + self.speculate
        toks = np.zeros((self.max_batch, K), np.int32)
        toks[:, 0] = self._tokens[:, 0]
        draft_len = np.zeros((self.max_batch,), np.int32)
        for slot, req in self._active.items():
            if req.sampling.top_k and req.sampling.temperature > 0:
                continue  # host-sampled: no draft
            draft = propose_ngram_draft(req.prompt + req.out_tokens, K - 1)
            if draft:
                draft_len[slot] = len(draft)
                self._stats["draft_tokens_proposed"] += len(draft)
                toks[slot, 1: 1 + len(draft)] = draft

        # An all-greedy batch skips the rejection-sampling tensors.
        any_stochastic = any(
            r.sampling.temperature > 0 and not r.sampling.top_k
            for r in self._active.values()
        )
        sampled, accept, rej, logits, self.cache = self._verify_paged(
            self.params,
            self._dev(toks),
            self.cache,
            self._dev(tables),
            self._dev(self._positions),
            self._dev(self._temps),
            self._gen,
            stochastic=any_stochastic,
        )
        sampled = sampled.cpu().numpy()  # [B, K]
        accept = accept.cpu().numpy()  # [B, K-1] bool
        rej = rej.cpu().numpy()  # [B, K-1]
        # n_acc[b] = index of the first rejected (or absent) draft.
        stop = ~accept
        stop |= np.arange(K - 1)[None, :] >= draft_len[:, None]
        n_acc = np.where(stop.any(axis=1), stop.argmax(axis=1), K - 1)
        host_logits = None
        for slot, req in list(self._active.items()):
            if req.sampling.top_k and req.sampling.temperature > 0:
                if host_logits is None:
                    host_logits = logits.cpu().numpy()  # [B, V]: pos 0
                tok = self._sample(host_logits[slot], req.sampling)
                self._record_token(req, tok, finished)
                continue
            na = int(n_acc[slot])
            # Accepted drafts verbatim, then the boundary token: the
            # residual sample where a draft was rejected, else the full-p
            # sample.
            emit = list(toks[slot, 1: 1 + na])
            if na < draft_len[slot]:
                emit.append(int(rej[slot, na]))
            else:
                emit.append(int(sampled[slot, na]))
            for idx, tok in enumerate(emit):
                self._record_token(req, int(tok), finished)
                if idx < na:
                    # Acceptance counts tokens actually emitted.
                    self._stats["draft_tokens_accepted"] += 1
                if req.done:
                    break

    def abort_request(self, request_id: str) -> bool:
        """Drop a request (queued or active), freeing its slot; returns
        False when it is unknown or already finished."""
        with self._lock:
            self._stream_ids.discard(request_id)
            self._deltas.pop(request_id, None)
            st = self._prefilling
            if st is not None and st["req"].request_id == request_id:
                self._prefilling = None
                self._free.append(st["slot"])
                self._release_pages(st["req"])
                self._stats["requests_aborted"] += 1
                return True
            for i, r in enumerate(self._queue):
                if r.request_id == request_id:
                    del self._queue[i]
                    self._stats["requests_aborted"] += 1
                    return True
            for slot, r in list(self._active.items()):
                if r.request_id == request_id:
                    r.done = True
                    del self._active[slot]
                    self._free.append(slot)
                    self._release_pages(r)
                    self._stats["requests_aborted"] += 1
                    return True
        return False

    def stats(self) -> dict:
        """Serving counters plus live occupancy: request and token
        totals, decode steps, speculative proposal/acceptance,
        preemptions, chunked-prefill progress, pool and slot use, and
        the process's kernel launches (each wrapper's count: the paged
        attention kernel and the flash forward), which a caller in
        another process, such as a serve client, reads here."""
        from ray_tpu_torch.ops.flash_attention import flash_attention_forward
        from ray_tpu_torch.ops.paged_attention import paged_attention

        with self._lock:
            out = dict(self._stats)
            out["active_requests"] = len(self._active)
            out["queued_requests"] = len(self._queue)
            out["prefilling"] = self._prefilling is not None
            if self.kv == "paged":
                out["pages_total"] = self.alloc.num_pages
                out["pages_free"] = self.alloc.free_pages
            out["kernel_launches"] = {
                "paged_attention": paged_attention.launches,
                "flash_attention_forward": flash_attention_forward.launches,
            }
            if out["draft_tokens_proposed"]:
                out["draft_acceptance_rate"] = round(
                    out["draft_tokens_accepted"]
                    / out["draft_tokens_proposed"],
                    4,
                )
        return out

    def drain_deltas(self) -> dict[str, list[int]]:
        """Return and clear per-request tokens emitted since the last
        call (the streaming feed)."""
        with self._lock:
            out, self._deltas = self._deltas, {}
        return out

    def generate(
        self,
        prompts: list[list[int]],
        sampling: SamplingParams | None = None,
    ) -> list[list[int]]:
        """Synchronous convenience: run all prompts to completion."""
        order = {}
        for i, p in enumerate(prompts):
            order[self.add_request(p, sampling)] = i
        results: list = [None] * len(prompts)
        while self.has_unfinished():
            for fin in self.step():
                results[order[fin["request_id"]]] = fin["tokens"]
        return results
