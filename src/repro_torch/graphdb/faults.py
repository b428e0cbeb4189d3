"""Deterministic fault injection at operator boundaries (DESIGN.md §13.1).

A ``FaultPlan`` is a seeded schedule of failures; ``faulty_spec`` wraps any
registered backend (``torch`` on cuda, ``torch[cpu]``, ``numpy``) in a
``FaultyOperatorSet`` that consults the plan before delegating each operator
call.  The wrapper is a
fully conforming ``OperatorSet`` — with no armed rules it passes the
OperatorSet-v2 conformance suite verbatim for whatever backend it wraps —
so the serving stack runs unmodified against it and the chaos phase of
``chip_smoke.py`` can prove containment end to end on the card.

Fault kinds:

``transient``
    raises ``InjectedFault(kind="transient")`` — a flake a bounded retry
    clears (the rule's ``count`` bounds how many calls fire).
``permanent``
    raises ``InjectedFault(kind="permanent")`` — retrying cannot help; the
    serving layer must fail/quarantine the offending binding or degrade.
``capacity``
    raises ``InjectedFault(kind="transient")`` flavored as a simulated
    capacity overflow (oversized intermediate); retryable by contract.
``latency``
    sleeps ``latency_s`` at the boundary, then delegates — for exercising
    the engine's cooperative deadline checks.

Determinism: rules fire on exact per-operator call counts (``after`` /
``count``) or via a ``random.Random(seed)`` coin (``p``); the same plan on
the same stream injects the same schedule.  Every injection is recorded on
the wrapper's ``FaultStats`` ledger (``physical_spec.FaultStats``), the
fourth sibling of the transfer/kernel/exchange ledgers.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import time

from repro_torch.core.errors import ExecError
from repro_torch.core.physical_spec import (ARRAY_PRIMITIVES, REQUIRED_OPERATORS,
                                      FaultStats, OperatorSet, PhysicalSpec,
                                      get_spec)

__all__ = ["FaultRule", "FaultPlan", "InjectedFault", "FaultyOperatorSet",
           "faulty_spec"]

#: operator boundaries the wrapper injects at: the six required operators,
#: the fused-chain dispatch (so chain-level faults can demote the
#: degradation ladder to the per-hop loop), and the engine's ``bind``
#: boundary — the one point where parameter binding *values* are visible
#: below the engine, so ``FaultRule(value=...)`` can poison one binding.
FAULT_POINTS = REQUIRED_OPERATORS + ("chain", "bind")


class InjectedFault(ExecError):
    """A failure raised by a ``FaultPlan`` at an operator boundary.  Carries
    the standard ``ExecError`` context (kind / operator / phase)."""


@dataclasses.dataclass
class FaultRule:
    """One entry in a ``FaultPlan``'s schedule.

    ``op`` names the boundary (one of ``FAULT_POINTS``, or ``"*"`` for
    any).  The rule arms after the boundary's ``after``-th matching call
    and fires on the next ``count`` calls (``count=None`` -> forever).
    Alternatively ``p`` fires with seeded probability per call.  ``value``
    restricts the rule to calls whose scalar arguments contain ``value`` —
    a deterministic way to poison one *binding* (parameter values reach
    operators like ``full``/``isin`` as scalars), not just one call index.
    """
    op: str = "*"
    kind: str = "transient"         # transient | permanent | capacity | latency
    after: int = 0
    count: int | None = 1
    p: float = 0.0
    latency_s: float = 0.0
    value: object = None

    def __post_init__(self):
        if self.kind not in ("transient", "permanent", "capacity", "latency"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.op != "*" and self.op not in FAULT_POINTS \
                and self.op not in ARRAY_PRIMITIVES:
            raise ValueError(f"unknown fault point {self.op!r}; "
                             f"expected one of {FAULT_POINTS}, an array "
                             f"primitive, or '*'")


class FaultPlan:
    """Seeded, deterministic injection schedule over operator boundaries.

    One plan instance carries mutable per-rule counters, so it must wrap
    exactly one operator set at a time (``faulty_spec`` enforces a fresh
    spec name per plan).  ``fired`` counts total injections; ``reset()``
    rewinds the schedule to replay it.
    """

    def __init__(self, rules: list[FaultRule] | tuple = (), seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._calls: dict[tuple[int, str], int] = {}   # (rule_idx, op) -> n
        self._fired: dict[int, int] = {}               # rule_idx -> n fired
        self.fired = 0

    def reset(self):
        self._rng = random.Random(self.seed)
        self._calls.clear()
        self._fired.clear()
        self.fired = 0

    def _matches_value(self, rule: FaultRule, scalars) -> bool:
        if rule.value is None:
            return True
        return any(s == rule.value for s in scalars)

    def check(self, op: str, scalars=(),
              wildcard: bool = True) -> FaultRule | None:
        """Advance the schedule for one call at boundary ``op`` and return
        the rule that fires, if any (first matching rule wins).
        ``wildcard=False`` (primitive boundaries) matches only rules that
        name ``op`` explicitly — ``"*"`` covers the logical operators."""
        for i, rule in enumerate(self.rules):
            if rule.op != op and (rule.op != "*" or not wildcard):
                continue
            if not self._matches_value(rule, scalars):
                continue
            key = (i, rule.op if rule.op != "*" else op)
            n = self._calls.get(key, 0)
            self._calls[key] = n + 1
            if rule.p > 0.0:
                if self._rng.random() >= rule.p:
                    continue
            elif n < rule.after:
                continue
            if rule.count is not None and self._fired.get(i, 0) >= rule.count:
                continue
            self._fired[i] = self._fired.get(i, 0) + 1
            self.fired += 1
            return rule
        return None


def _scalar_args(args) -> tuple:
    """The plain-scalar positional arguments of an operator call — the
    hook ``FaultRule.value`` matches against (binding parameters surface
    here via ``full(n, value)`` / ``searchsorted`` probes)."""
    return tuple(a for a in args if isinstance(a, (int, float, str, bool)))


class _FaultyChainProgram:
    """Chain-program proxy: delegates to the wrapped backend's compiled
    program, injecting at the ``chain`` boundary on each ``run``."""

    def __init__(self, prog, owner: "FaultyOperatorSet"):
        self._prog = prog
        self._owner = owner

    def ready(self) -> bool:
        return self._prog.ready()

    def observe(self, hop_sizes):
        return self._prog.observe(hop_sizes)

    def run(self, src_col, nrows, scalars, value_lists, max_rows):
        self._owner._boundary("chain", tuple(scalars))
        return self._prog.run(src_col, nrows, scalars, value_lists, max_rows)

    def __getattr__(self, name):
        return getattr(self._prog, name)


class FaultyOperatorSet(OperatorSet):
    """Conforming wrapper around any ``OperatorSet`` that injects a
    ``FaultPlan`` at operator boundaries.

    Transfer/kernel/exchange ledgers are the *inner* set's (so residency
    and compile accounting flow through unchanged); the fault ledger is the
    wrapper's own.  All required operators and array primitives are defined
    on this class (delegators installed below) so
    ``validate_operator_set``'s defined-on-the-class check passes.
    """

    def __init__(self, inner: OperatorSet, plan: FaultPlan, name: str):
        # no super().__init__: ledgers delegate to the wrapped set
        self.inner = inner
        self.plan = plan
        self.store = inner.store
        self.name = name
        self.supports_chains = inner.supports_chains
        self.compiled = inner.compiled
        # the staging dtype the conformance and dtype oracles pin
        # (``physical_spec.validate_operator_set``): a wrapped torch set
        # stages int32, the numpy set declares none
        self.index_dtype = inner.index_dtype
        self.on_host = inner.on_host
        self.fault_stats = FaultStats()

    # shared ledgers -------------------------------------------------------
    @property
    def transfer_stats(self):
        return self.inner.transfer_stats

    @property
    def kernel_stats(self):
        return self.inner.kernel_stats

    @property
    def exchange_stats(self):
        return self.inner.exchange_stats

    def reset_ledgers(self):
        self.inner.reset_ledgers()
        self.fault_stats.reset()

    # injection ------------------------------------------------------------
    def _boundary(self, op: str, scalars=(), wildcard: bool = True):
        rule = self.plan.check(op, scalars, wildcard)
        if rule is None:
            return
        self.fault_stats.record(rule.kind, op)
        phase = self.inner.transfer_stats.phase or None
        if rule.kind == "latency":
            time.sleep(rule.latency_s)
            return
        if rule.kind == "capacity":
            raise InjectedFault(
                f"injected capacity overflow at {op!r}", kind="transient",
                operator=op, phase=phase)
        raise InjectedFault(f"injected {rule.kind} fault at {op!r}",
                            kind=rule.kind, operator=op, phase=phase)

    def binding_boundary(self, binding: dict | None):
        """Engine hook (``Engine._offer_bindings``): one call per parameter
        binding at execution start.  Matches only rules that name ``"bind"``
        explicitly — a wildcard firing here would fail every execution
        before its first operator."""
        scalars = _scalar_args(tuple((binding or {}).values()))
        self._boundary("bind", scalars, wildcard=False)

    # capabilities ---------------------------------------------------------
    def chain_program(self, spec):
        prog = self.inner.chain_program(spec)
        if prog is None:
            return None
        return _FaultyChainProgram(prog, self)

    def pin_chain(self, spec, pinned: bool = True) -> bool:
        return self.inner.pin_chain(spec, pinned)

    def block_ready(self, arrays):
        return self.inner.block_ready(arrays)


def _delegator(name: str, inject: bool, wildcard: bool = True):
    def method(self, *args, **kwargs):
        if inject:
            self._boundary(name, _scalar_args(args), wildcard)
        return getattr(self.inner, name)(*args, **kwargs)
    method.__name__ = name
    method.__qualname__ = f"FaultyOperatorSet.{name}"
    method.__doc__ = (f"Delegates to the wrapped set's ``{name}``"
                      + (", after the fault boundary." if inject else "."))
    return method


# install explicit delegators: required operators pass through the fault
# boundary, and ``"*"`` rules match them; array primitives pass through too
# but only fire rules that *name* them (``"*"`` on take/mask/... would fire
# inside fused programs unpredictably across backends) — naming a primitive
# like ``full`` is how a rule poisons one binding value deterministically.
for _n in REQUIRED_OPERATORS:
    setattr(FaultyOperatorSet, _n, _delegator(_n, inject=True))
for _n in ARRAY_PRIMITIVES:
    setattr(FaultyOperatorSet, _n, _delegator(_n, inject=True,
                                              wildcard=False))
for _n in ("_array_to_host", "vertex_prop", "edge_prop"):
    setattr(FaultyOperatorSet, _n, _delegator(_n, inject=False))
del _n

_SPEC_IDS = itertools.count()


def faulty_spec(backend: str | PhysicalSpec, plan: FaultPlan,
                name: str | None = None) -> PhysicalSpec:
    """A ``PhysicalSpec`` wrapping ``backend``'s operator set in ``plan``.

    The spec gets a unique name (operator-set caches and plan caches are
    keyed by spec name, so two fault plans never share a wrapper) and is
    *not* registered globally — pass the spec object itself wherever a
    backend is accepted (``GOpt.prepare(backend=...)``,
    ``QueryServer(backend=...)``).
    """
    base = get_spec(backend)
    if name is None:
        name = f"faulty:{base.name}:{next(_SPEC_IDS)}"

    def make(store, _base=base, _plan=plan, _name=name):
        return FaultyOperatorSet(_base.operators(store), _plan, _name)

    return PhysicalSpec(name=name, make_operators=make, cost=base.cost,
                        description=f"fault-injecting wrapper over "
                                    f"{base.name!r} ({len(plan.rules)} rules)",
                        physical_rules=base.physical_rules)
