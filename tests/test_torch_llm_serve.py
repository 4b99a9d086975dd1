"""The port's LLM deployment against the JAX package's, on the tiny
preset in fp32 on the CPU: ``LLMServer.generate`` and ``LLMServer.stream``
give identical token streams on the same weights (each side driven in
one asyncio loop, no cluster), the port's ``serve.run`` of
``build_llm_deployment`` gives the same tokens over its HTTP proxy (unary
JSON and SSE), and ``build_batch_inferencer``'s class gives the JAX
package's text on a batch dict."""

import asyncio
import concurrent.futures
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ray_tpu.llm.batch import build_batch_inferencer as jax_inferencer
from ray_tpu.llm.serve_integration import LLMServer as JaxServer
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import build_batch_inferencer, build_llm_deployment
from ray_tpu_torch.llm.serve_integration import LLMServer
from ray_tpu_torch.models.llama import PRESETS, params_from_jax

CFG = PRESETS["tiny"]
JCFG = jllama.PRESETS["tiny"]
PROMPTS = ("hello world", "the quick brown fox", "a", "serve me 12 tokens")
MAX_TOKENS = 12
# The same engine on both sides: a pool of 16-token pages, two slots, so
# four concurrent requests queue and share decode batches.
ENGINE = {"max_batch": 2, "max_seq": 64, "page_size": 16}

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.key(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), CFG, "cpu")


async def _collect(agen) -> list:
    return [d async for d in agen]


async def _drive(server) -> tuple[list, list]:
    """Every prompt through ``generate``, then through ``stream``, each
    batch of four concurrent in one loop: (token lists, delta lists)."""
    outs = await asyncio.gather(
        *(server.generate(p, max_tokens=MAX_TOKENS) for p in PROMPTS))
    streams = await asyncio.gather(
        *(_collect(server.stream(p, max_tokens=MAX_TOKENS))
          for p in PROMPTS))
    return ([o["tokens"] for o in outs],
            [[d["tokens"] for d in s] for s in streams])


@pytest.fixture(scope="module")
def port_streams(tparams):
    server = LLMServer("tiny", {**ENGINE, "params": tparams,
                                "device": "cpu"})
    return asyncio.run(_drive(server))


def _joined(deltas):
    return [t for d in deltas for t in d]


def test_llm_server_matches_reference(jparams, port_streams):
    want_outs, want_deltas = asyncio.run(
        _drive(JaxServer("tiny", {**ENGINE, "params": jparams})))
    outs, deltas = port_streams
    assert all(len(o) == MAX_TOKENS for o in outs)
    assert outs == want_outs
    assert [_joined(d) for d in deltas] == [_joined(d) for d in want_deltas]
    # A stream carries the same tokens as the unary answer.
    assert [_joined(d) for d in deltas] == outs


def test_llm_server_refuses_cpu_default(monkeypatch):
    """Without a device the engine asks for the card, as every port
    entry point does, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        LLMServer("tiny", dict(ENGINE))


def _post(port, body) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/llm",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _sse(port, body) -> list:
    """One SSE request: the token deltas of its frames, in order, after
    checking that the stream ends in ``data: [DONE]``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm", data=json.dumps(body).encode(),
        headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert "text/event-stream" in resp.headers["Content-Type"]
        text = resp.read().decode()
    frames = [e.removeprefix("data: ") for e in text.split("\n\n")
              if e.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f)["tokens"] for f in frames[:-1]]


def test_http_deployment_matches_in_process(tparams, port_streams):
    import ray_tpu_torch
    from ray_tpu_torch import serve

    outs, deltas = port_streams
    ray_tpu_torch.init(num_cpus=4)
    try:
        app = build_llm_deployment(
            "tiny", engine_kwargs={**ENGINE, "params": tparams,
                                   "device": "cpu"})
        serve.run(app, name="llm_parity", route_prefix="/llm",
                  timeout_s=120)
        port = serve.start_http()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            unary = [pool.submit(_post, port, {"prompt": p,
                                              "max_tokens": MAX_TOKENS})
                     for p in PROMPTS]
            sse = [pool.submit(_sse, port, {"prompt": p,
                                           "max_tokens": MAX_TOKENS,
                                           "stream": True})
                   for p in PROMPTS]
            got_unary = [f.result()["tokens"] for f in unary]
            got_sse = [f.result() for f in sse]
        assert got_unary == outs
        assert [_joined(d) for d in got_sse] == [_joined(d) for d in deltas]
        stats = _post(port, {"method": "stats"})
        assert stats["requests_finished"] == 2 * len(PROMPTS)
        # The replica ran the plain versions: CPU tensors launch nothing.
        assert stats["kernel_launches"] == {"paged_attention": 0,
                                            "flash_attention_forward": 0}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


def test_batch_inferencer_matches_reference(jparams, tparams):
    batch = {"prompt": list(PROMPTS), "id": list(range(len(PROMPTS)))}
    want = jax_inferencer("tiny", engine_kwargs={**ENGINE,
                                                 "params": jparams},
                          max_tokens=MAX_TOKENS)()(dict(batch))
    cls = build_batch_inferencer(
        "tiny", engine_kwargs={**ENGINE, "params": tparams,
                               "device": "cpu"},
        max_tokens=MAX_TOKENS)
    assert cls.__name__ == "LLMInferencer_tiny"
    got = cls()(dict(batch))
    assert got["id"] == batch["id"]
    assert got["generated"] == want["generated"]
