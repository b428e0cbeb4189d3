"""Shared exception types for the GOpt front-end (DESIGN.md §3).

``BuildError`` is raised eagerly by ``GraphIrBuilder`` at the offending
construction step (unknown label / alias / property), with the step position
in the message — queries fail at build time, not deep inside the optimizer
or the engine.  ``ParamError`` covers every parameter-lifecycle failure:
structural parameters missing at build time, unbound parameters at
execution, and bindings that name no declared parameter.
"""
from __future__ import annotations


class GOptError(Exception):
    """Base class for all GOpt front-end errors."""


class BuildError(GOptError, ValueError):
    """Build-time validation failure in ``GraphIrBuilder``."""

    def __init__(self, message: str, step: tuple[int, str] | None = None):
        self.step = step
        if step is not None:
            message = f"step {step[0]} ({step[1]}): {message}"
        super().__init__(message)


class PipelineError(GOptError, ValueError):
    """Invalid ``OptimizerPipeline`` registration: unknown phase, duplicate
    pass name, or a ``before=``/``after=`` anchor that does not exist (or
    lives in a different phase)."""


class PlanInvariantError(GOptError, AssertionError):
    """A plan failed the ``PlanVerifier``'s static invariant checks
    (``core/verify.py``).

    Under ``verify="always"`` the optimizer pipeline verifies after every
    registered pass, so ``pass_name``/``phase`` identify the rewrite that
    produced the invalid plan and ``trace`` is its ``PassTrace`` — including
    the before/after plan diff — at the moment of the violation.
    ``pass_name`` is ``None`` when the violation was only detected on the
    pipeline's final output (``verify="cached"``)."""

    def __init__(self, violations, pass_name: str | None = None,
                 phase: str | None = None, trace=None):
        self.violations = tuple(violations)
        self.pass_name = pass_name
        self.phase = phase
        self.trace = trace
        where = (f"after pass {pass_name!r} ({phase})"
                 if pass_name else "in pipeline output")
        lines = [f"invalid plan {where}: "
                 f"{len(self.violations)} invariant violation(s)"]
        lines.extend(f"  - {v}" for v in self.violations)
        diff = list(getattr(trace, "diff", []) or [])
        if diff:
            lines.append("  plan diff:")
            lines.extend(f"    {d}" for d in diff)
        super().__init__("\n".join(lines))


class ExecError(GOptError, RuntimeError):
    """Structured execution failure (DESIGN.md §13).

    Classifies a failed operator/plan execution for the serving layer's
    containment machinery: ``kind`` is ``"transient"`` (retry may succeed:
    capacity overflow, injected flake, lost device), ``"permanent"`` (the
    binding or plan is poison — retrying the same work cannot help), or
    ``"deadline"`` (the request's budget expired mid-execution).  The
    remaining fields carry the failure's context: the operator boundary it
    surfaced at, the engine phase tag active at the time (``pattern`` /
    ``tail`` / ``deliver``), the plan cache key, how many attempts were
    made, and the underlying exception (also chained via ``__cause__``).
    """

    kind: str = "permanent"

    def __init__(self, message: str, *, kind: str | None = None,
                 operator: str | None = None, phase: str | None = None,
                 plan=None, attempts: int = 1,
                 cause: BaseException | None = None):
        if kind is not None:
            self.kind = kind
        self.operator = operator
        self.phase = phase
        self.plan = plan
        self.attempts = attempts
        self.cause = cause
        ctx = [f"kind={self.kind}"]
        if operator:
            ctx.append(f"op={operator}")
        if phase:
            ctx.append(f"phase={phase}")
        if plan is not None:
            # plan cache keys embed the whole normalized query; keep the
            # message scannable, the full key stays on ``self.plan``
            p = str(plan).replace("\n", " ")
            ctx.append(f"plan={p[:60]}…" if len(p) > 60 else f"plan={p}")
        if attempts != 1:
            ctx.append(f"attempts={attempts}")
        super().__init__(f"{message} [{', '.join(ctx)}]")
        if cause is not None:
            self.__cause__ = cause

    @property
    def transient(self) -> bool:
        return self.kind == "transient"


class TransientExecError(ExecError):
    """An execution failure that a bounded retry may clear (capacity
    overflow, flaky kernel dispatch, lost device)."""

    kind = "transient"


class PermanentExecError(ExecError):
    """An execution failure retrying cannot fix: the binding or plan is
    poison for this backend."""

    kind = "permanent"


class DeadlineExceeded(ExecError):
    """A request's ``deadline_s`` expired mid-execution; the engine aborted
    the tail cooperatively (checked between operators, DESIGN.md §13.4)."""

    kind = "deadline"


class StaleSnapshotError(RuntimeError):
    """Raised when executing against a snapshot retired by compaction."""


#: exception types that are transient by nature even when raised outside
#: the structured taxonomy (OS-level hiccups, queue overflow).
_TRANSIENT_TYPES = (TimeoutError, ConnectionError, InterruptedError)


def classify_error(exc: BaseException) -> str:
    """Map an arbitrary execution exception to an ``ExecError`` kind.

    Structured errors carry their own ``kind``; OS-flavored hiccups are
    transient; everything else defaults to permanent so unknown failures
    never trigger a retry storm.
    """
    if isinstance(exc, ExecError):
        return exc.kind
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    return "permanent"


class ParamError(GOptError, LookupError):
    """A query-parameter problem, naming the offending parameters and the
    declared set."""

    def __init__(self, message: str, missing=(), extra=(), declared=()):
        self.missing = tuple(sorted(missing))
        self.extra = tuple(sorted(extra))
        self.declared = tuple(sorted(declared))
        detail = []
        if self.missing:
            detail.append("missing: " + ", ".join(f"${p}" for p in self.missing))
        if self.extra:
            detail.append("unexpected: " + ", ".join(f"${p}" for p in self.extra))
        detail.append("declared: {" + ", ".join(f"${p}" for p in self.declared)
                      + "}")
        super().__init__(f"{message} ({'; '.join(detail)})")
