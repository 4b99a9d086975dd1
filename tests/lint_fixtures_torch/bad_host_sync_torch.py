"""TPU601 fixture: torch's host syncs in hot regions, one case each.

Exact rule ids + lines are pinned in test_torch_lint.py.
"""
import torch
import ray_tpu_torch.train as train


def cuda_synchronize_in_step(state, step_fn, batch):
    with train.step_span():
        state = step_fn(state, batch)
        torch.cuda.synchronize()                # torch.cuda.synchronize
    return state


def event_synchronize_in_step_loop(batches, step_fn):
    for batch in batches:
        done = torch.cuda.Event()
        step_fn(batch)
        done.record()
        done.synchronize()                      # Event.synchronize
        train.report({"step": 1})


def cpu_in_compute_phase(sp, logits):
    with sp.phase("compute"):
        return logits.cpu()                     # .cpu() on a tensor


def tolist_in_step(tokens, step_fn):
    with train.step_span():
        step_fn(tokens)
        return tokens.tolist()                  # .tolist() on a tensor


def _host_ids(ids):
    return ids.tolist()


def transitive_tolist(sp, ids):
    with sp.phase("compute"):
        return _host_ids(ids)                   # reaches .tolist()


def quiet_forms(sp, x, batches):
    # None of these fires: .to("cpu") is not a named sync verb, float()
    # is a weak sync outside a compute span, a checkpoint phase is a
    # declared blocking phase, and the last .cpu() is outside the span.
    with train.step_span():
        y = x.to("cpu")
        z = float(x)
        with sp.phase("checkpoint"):
            w = x.cpu()
            torch.cuda.synchronize()
    return y, z, w, x.cpu()
