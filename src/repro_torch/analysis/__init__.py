"""``dslint`` for the port — the serving stack's invariant linter over
``src/repro_torch/``.

The port's copy of ``repro.analysis``, which lints only ``src/repro/``.
The port's coordination disciplines (retry-wrapped store/queue ops,
durable-before-ack ordering, byte-determinism of engine ticks, counter
plumbing from ``EngineStats`` through ``snapshot()`` to the docs and the
bench) are the reference's, so the rules, the fingerprints, the pragma
grammar and the baseline format are too.  It is pure ``ast``: no module
here imports ``torch``, ``jax`` or ``repro``, and nothing of the
reference is read at lint time.  ``docs/analysis.md`` is the catalog,
with the motivating bug behind each rule.

Rules (``--list-rules``):

- R0 — pragma and baseline hygiene (the engine's own findings);
- R1 — lease-path store/queue ops run under ``_with_retries`` /
  ``_retry_transient`` / ``AsyncPublisher``, never bare;
- R2 — a queue ack never precedes the durable put it guards;
- R3 — no wall clock, unseeded RNG or unordered-set iteration on
  engine-tick paths;
- R4 — ``EngineStats`` fields, ``snapshot()``, ``docs/serving.md`` and
  the bench schema agree;
- R5 — attributes written from a thread target and the caller side are
  lock-guarded, and lease modules' module-level containers declare
  their ownership;
- R6 — every public ``kernels/ops.py`` entry point has an ``ORACLES``
  entry in ``kernels/ref.py`` and a parity test;
- R7 — every ``DSConfig`` field is consumed or refused in
  ``INERT_PAPER_FIELDS``.

Where the port's rules differ from the reference's:

- R3 also bans draws from torch's global generator (``torch.rand``,
  ``randn``, ``randint``, ``randperm``, ``multinomial``, ``bernoulli``,
  ``normal``, their ``*_like`` forms, and ``Tensor.uniform_`` /
  ``normal_`` / ``exponential_`` / ``random_`` / ``bernoulli_``) unless
  the call passes ``generator=``;
- R6 reads ``tests/test_torch_kernels.py`` for the parity tests, and
  its message names a plain-torch oracle;
- R4's bench anchors are the port's own benchmark's files,
  ``benchmarks_torch/check_bench.py``,
  ``tests/test_torch_bench_serving.py`` and ``BENCH_serving_torch.json``;
  until they exist its parts 3-4 are dormant (the rule skips an absent
  anchor quietly).  ``docs/serving.md`` documents both packages'
  counters and is read as is.

Run it::

    PYTHONPATH=src python -m repro_torch.analysis            # full tree
    PYTHONPATH=src python -m repro_torch.analysis --changed  # inner loop
    PYTHONPATH=src python -m repro_torch.analysis --list-rules

Tier-1 runs the full tree via ``tests/test_torch_analysis.py``, which
also holds this linter to ``repro.analysis`` finding for finding.

Suppression is explicit and audited:

- inline pragma: ``# dslint: disable=R1(reason)`` on the offending
  line or on the enclosing ``def``/``class`` header;
- the committed baseline (``baseline.json`` next to this file) for
  grandfathered findings, each entry carrying a written justification.

An empty reason or justification is itself a finding (rule R0), so
nothing can be silenced without saying why.
"""

from repro_torch.analysis.engine import (  # noqa: F401
    Finding,
    Project,
    Report,
    run_analysis,
)
from repro_torch.analysis.rules import ALL_RULES  # noqa: F401
