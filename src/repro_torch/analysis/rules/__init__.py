"""dslint rule registry.

``ALL_RULES`` is the ordered list the engine runs by default.  Adding a
rule: write a module here with a ``Rule`` subclass, instantiate it in
``ALL_RULES``, document it in ``docs/analysis.md``, and add tripping +
passing fixtures: ``tests/fixtures/dslint/`` holds the ones both
packages' linters share, ``tests/test_torch_analysis.py`` the port's
own.
"""

from __future__ import annotations

from repro_torch.analysis.rules.common import Rule
from repro_torch.analysis.rules.counters import CounterRegistryRule
from repro_torch.analysis.rules.determinism import DeterminismRule
from repro_torch.analysis.rules.durability import DurableBeforeAckRule
from repro_torch.analysis.rules.kernels import KernelOracleRule
from repro_torch.analysis.rules.knobs import InertKnobRule
from repro_torch.analysis.rules.retry import RetryDisciplineRule
from repro_torch.analysis.rules.threads import ThreadSharedStateRule

ALL_RULES = [
    RetryDisciplineRule(),
    DurableBeforeAckRule(),
    DeterminismRule(),
    CounterRegistryRule(),
    ThreadSharedStateRule(),
    KernelOracleRule(),
    InertKnobRule(),
]

__all__ = ["ALL_RULES", "Rule"]
