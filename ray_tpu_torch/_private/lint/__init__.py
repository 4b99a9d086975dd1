"""tpulint: ray_tpu_torch-specific static analysis.

The JAX package's linter (``ray_tpu/_private/lint/``) on the port's
tree: sixteen passes grounded in the runtime's real failure classes,
the flow-sensitive ones built on the interprocedural dataflow engine
(``dataflow.py``: module symbol tables + call graph + alias sets + a
branch/loop/early-return-aware abstract interpreter):

- ``collective-divergence`` (TPU101/TPU102): collective ops under
  rank-dependent control flow — the SPMD deadlock shape.
- ``rank-divergence-flow`` (TPU103): the same hazard hidden behind
  helper calls, tracked through the call graph and per-path guards.
- ``dropped-handle`` (TPU104): ``*_async()`` CollectiveWork handles
  discarded, never ``wait()``ed on a path, or overwritten pending.
- ``lock-discipline`` (TPU201/TPU202): blocking calls while a
  ``threading.Lock`` with-block is open, plus cross-function
  lock-order cycles.
- ``async-lock`` (TPU203): threading locks held across ``await``,
  blocking calls inside ``asyncio.Lock`` sections, unbalanced manual
  acquires in ``async def``.
- ``lock-alias`` (TPU204): locks passed as arguments / stored in
  attributes or containers joining the TPU202 order graph.
- ``broad-except`` (TPU301): ``except Exception``/bare ``except``
  that neither re-raises, logs, nor carries an allow pragma.
- ``metric-hygiene`` (TPU401/TPU402/TPU403): metric constructors in
  functions, span CMs (``torch_profile`` among them) never entered,
  unbounded metric labels.
- ``resource-pairing`` (TPU404): ``memory.track()`` registrations
  never closed, span ``__enter__`` without exception-safe
  ``__exit__`` — checked path-sensitively.
- ``rpc-reentrancy`` (TPU501): RPC handlers that call back into an
  RPC handled by their own process (self-deadlock).
- ``host-sync-in-hot-path`` (TPU601): torch's host syncs
  (``torch.cuda.synchronize()``, a stream's or event's
  ``synchronize()``, ``.cpu()``, ``.tolist()``, ``.item()``; and, in
  compute-phase spans, ``float()``/``np.asarray()``) reached —
  transitively — from a step loop or compute span; the ``wait()`` tail
  join is exempt.
- ``rpc-contract-drift`` (TPU701): every ``*.call("m", **kw)`` site
  bound cross-file to its ``async def _on_m(self, conn, ...)``
  handler — unknown methods, kwargs ``tolerant_kwargs`` would silently
  drop, required params never passed, positional payloads that become
  the transport ``timeout``.
- ``journal-replay-completeness`` (TPU702): every ``(table, op)``
  written via ``_journal_append`` needs a replay branch in
  ``_restore_from_journal`` and a snapshot field; replayed payload
  keys must be a subset of the keys every append writes.
- ``knob-discipline`` (TPU703): ``config.get`` keys absent from
  ``CONFIG_DEFS``, raw ``RAY_TPU_*`` env reads outside the config
  layer, dead declared-but-never-read knobs, drift in the README's
  section on the port.
- ``pubsub-channel-discipline`` (TPU704): publishes nobody hears,
  subscriptions to never-published channels, push handlers blind to
  the coalesced ``{"batch": [...]}`` frame shape.
- ``metric-schema-drift`` (TPU705): one metric name registered with
  differing label sets or types across modules.

Not ported: the JAX package's four jit passes (TPU602
``jit-side-effect``, TPU603 ``recompilation-hazard``, TPU604
``donation-misuse``, TPU605 ``jit-boundary-divergence``) and their
helper ``jit_util.py``. They analyse ``jax.jit``-traced bodies, their
static arguments and donated buffers; the port traces and compiles
nothing, so they have nothing to analyse here (nor have their
sanitizer twins, the compile watch and the host-sync tracer).

TPU701 has a runtime twin (``sanitize.check_rpc_contract``, armed in
``Connection.call`` by ``RAY_TPU_SANITIZE=1`` — the runtime backstop
for the dynamic-method and ``**kw``-splat sites the static pass must
skip), and it validates against this package's
``protocol.handler_signature_table()``.

Violations are suppressed line-by-line with::

    # tpulint: allow(<rule> reason=<why this is deliberate>)

The tree is clean and has no baseline; the baseline plumbing
(``--baseline``/``--update-baseline``) remains for third-party trees
adopting the linter with existing debt. Use ``python -m
ray_tpu_torch.scripts lint --changed`` on the pre-commit path: it lints
only the files in ``git diff`` plus their call-graph neighbors.
"""

from ray_tpu_torch._private.lint.core import (  # noqa: F401
    Violation,
    analyze_file,
    analyze_paths,
    analyze_source,
)
from ray_tpu_torch._private.lint.baseline import (  # noqa: F401
    diff_against_baseline,
    load_baseline,
    make_baseline,
)
