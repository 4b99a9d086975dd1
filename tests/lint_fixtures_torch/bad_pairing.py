# tpulint fixture: unbalanced resource pairing (TPU404).
# Line numbers are pinned by tests/test_torch_lint.py — edit with care.
from ray_tpu_torch.runtime import memory
from ray_tpu_torch import tracing


def discarded_claim(nbytes):
    memory.track("fixture.pool", kind="kv_cache", nbytes=nbytes)  # TPU404 @ 8
    return nbytes


def leaked_on_path(nbytes, flag):
    reg = memory.track("fixture.buf", nbytes=nbytes)  # TPU404 @ line 13
    if flag:
        reg.close()
        return True
    return False


def unsafe_span(payload):
    s = tracing.span("fixture:work")
    s.__enter__()  # TPU404 @ line 22 (__exit__ not exception-safe)
    result = process(payload)
    s.__exit__(None, None, None)
    return result


def process(payload):
    return payload
