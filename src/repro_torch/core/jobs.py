"""Job files — the paper's Step 2 (``submitJob``).

The port's own copy of the reference package's ``core/jobs.py`` (the
port imports nothing of the reference), behaviour unchanged.

A job file is shared metadata plus a ``groups`` list; DS enqueues one SQS
message per group, each message carrying ``shared ∪ group``.  We keep that
exact contract: grouping choice is the user's parallelism knob ("many
small machines ... or a large machine to perform a single task").

For the training "Something", a group is typically a *step span*
(``{"start_step": 0, "num_steps": 50}``) or a hyper-parameter setting;
for serving it is a request batch; for eval a data shard.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class JobFile:
    shared: Dict[str, Any] = field(default_factory=dict)
    groups: List[Dict[str, Any]] = field(default_factory=list)

    def expand(self) -> List[Dict[str, Any]]:
        """One message body per group: shared keys overlaid by group keys."""
        out = []
        for i, group in enumerate(self.groups):
            body = dict(self.shared)
            body.update(group)
            body.setdefault("group_index", i)
            out.append(body)
        return out

    def to_json(self) -> str:
        d = dict(self.shared)
        d["groups"] = self.groups
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "JobFile":
        d = dict(d)
        groups = d.pop("groups", [])
        if not isinstance(groups, list):
            raise ValueError("'groups' must be a list")
        norm = []
        for g in groups:
            if isinstance(g, dict):
                norm.append(g)
            else:
                # the paper allows plain strings appended from a txt file
                norm.append({"group": g})
        return cls(shared=d, groups=norm)

    @classmethod
    def from_json(cls, text: str) -> "JobFile":
        return cls.from_dict(json.loads(text))


def load_job_file(path: str) -> JobFile:
    with open(path) as f:
        return JobFile.from_json(f.read())


def step_span_job_file(
    *,
    arch: str,
    total_steps: int,
    span: int,
    run: str = "run0",
    shared: Dict[str, Any] | None = None,
) -> JobFile:
    """Build a training job file whose groups are contiguous step spans.

    This is the canonical decomposition for ``distributed-train``:
    checkpoint-delimited spans make every job idempotent and resumable —
    the paper's CHECK_IF_DONE generalized to training state.  Each group
    carries its ``output_prefix`` so the generic worker's done-check can
    skip completed spans on resubmission.
    """
    groups = [
        {
            "start_step": s,
            "num_steps": min(span, total_steps - s),
            "output_prefix": f"runs/{run}/spans/{s:06d}-{min(s + span, total_steps):06d}",
        }
        for s in range(0, total_steps, span)
    ]
    base = {"arch": arch, "total_steps": total_steps, "run": run}
    if shared:
        base.update(shared)
    return JobFile(shared=base, groups=groups)
