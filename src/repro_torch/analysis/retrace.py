"""Rebuild and signature auditing of the committer's programs (port of
repro.analysis.retrace).

A JAX program traces once a signature, the (shape, dtype, sharding) tuple
of its arguments. A torch program does not trace, but the window
committer builds its steps (``make_fabric_step``) once a (depth, channels)
key and keeps them, and whatever runs a step ahead of the host later, a
CUDA graph or a worker thread, is bound to one signature of its arguments
(shapes, dtypes, devices). So the auditor counts, per program name:

  * ``builds``     -- the programs the committer built under the name;
  * ``traces``     -- calls on a signature new to the build that made
                      them (a build's first call, or a new shape): what a
                      JIT would trace, or a graph would capture;
  * ``signatures`` -- the distinct signatures seen.

and flags

  * a trace on a signature an earlier build already ran
                                          -> ``retrace.recompiled``
    (a step rebuilt for a key the committer had: a lost cache)
  * more distinct signatures than the contract's budget
                                          -> ``retrace.signature_churn``

Wiring: ``WindowCommitter.attach_retrace_auditor(auditor)`` routes every
program the committer builds or calls (window steps, the stats pass, the
resize exchange) through :meth:`RetraceAuditor.wrap`; the gate drives a
small workload through it (windows, a tail window, stats reads, a resize,
more windows).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.checks import Violation


def signature(args: tuple, kwargs: dict | None = None) -> str:
    """The key a call would be traced or captured under: the structure of
    the arguments, the shape, dtype and device of each tensor, the repr of
    every other leaf."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return f"{x.dtype}{tuple(x.shape)}@{x.device}"
        return repr(x)

    leaves, spec = tree_flatten((args, kwargs or {}))
    return f"{spec}|" + ";".join(leaf(x) for x in leaves)


@dataclasses.dataclass
class ProgramAudit:
    """Per-program build and call history."""

    name: str
    builds: int = 0
    traces: int = 0
    calls: int = 0
    seen: dict = dataclasses.field(default_factory=dict)  # sig -> traces
    violations: list = dataclasses.field(default_factory=list)


class RetraceAuditor:
    """Wraps the committer's programs; records and polices their builds
    and signatures."""

    def __init__(self, max_signatures: int | dict | None = None):
        # int: one budget for all programs; dict: per name with "default";
        # None: contracts.retrace_budget.
        self._max_signatures = max_signatures
        self.programs: dict[str, ProgramAudit] = {}

    def _budget(self, name: str) -> int:
        ms = self._max_signatures
        if isinstance(ms, dict):
            return int(ms.get(name, ms.get("default", 4)))
        if ms is None:
            from repro_torch.analysis import contracts

            return contracts.retrace_budget(name)
        return int(ms)

    def wrap(self, name: str, fn):
        """``fn`` as one build of program ``name``, with call accounting."""
        rec = self.programs.setdefault(name, ProgramAudit(name))
        rec.builds += 1
        mine: set = set()  # signatures this build has run

        def audited(*args, **kwargs):
            sig = signature(args, kwargs)
            rec.calls += 1
            if sig not in mine:
                mine.add(sig)
                rec.traces += 1
                self._on_trace(rec, sig)
            return fn(*args, **kwargs)

        audited._audit = rec
        return audited

    def _on_trace(self, rec: ProgramAudit, sig: str) -> None:
        if sig in rec.seen:
            rec.seen[sig] += 1
            rec.violations.append(Violation(
                rec.name, "retrace.recompiled",
                f"call #{rec.calls} ran a signature an earlier build already "
                f"ran (trace {rec.seen[sig]} of {sig[:120]}...): the "
                "program was rebuilt for a key its owner had"))
            return
        rec.seen[sig] = 1
        budget = self._budget(rec.name)
        if len(rec.seen) > budget:
            rec.violations.append(Violation(
                rec.name, "retrace.signature_churn",
                f"{len(rec.seen)} distinct signatures, budget {budget} "
                "(allowed: the first window, a tail window, one per resize "
                "epoch) -- something varies a shape every round"))

    @property
    def violations(self) -> list[Violation]:
        return [v for rec in self.programs.values() for v in rec.violations]

    def report(self) -> dict:
        return {
            name: {
                "calls": rec.calls,
                "builds": rec.builds,
                "traces": rec.traces,
                "signatures": len(rec.seen),
                "violations": [str(v) for v in rec.violations],
            }
            for name, rec in sorted(self.programs.items())
        }
