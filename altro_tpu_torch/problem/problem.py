"""Problem definition and compilation into knot families
(`altro_tpu/problem/problem.py`).

`Problem` mirrors the reference's per-knot container
(`altro/problem/problem.hpp:65-307`); `Problem.compile()` groups knot points
into families that share a function and stacks their parameters, so each
family evaluates as one batched tensor operation over its knots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional, Union

import numpy as np
import torch

from .constraints import Cone, Constraint
from .costs import Cost
from .dynamics import DiscreteModel

KnotSel = Union[int, Iterable[int]]


def _as_knots(k: KnotSel) -> list[int]:
    if isinstance(k, (int, np.integer)):
        return [int(k)]
    return [int(i) for i in k]


@dataclasses.dataclass
class _CostFamily:
    fn: Any
    expand_fn: Any
    name: str
    knots: np.ndarray  # sorted knot indices
    shared: bool  # params shared across knots vs stacked along axis 0
    cost: Any = None  # representative Cost


@dataclasses.dataclass
class _ConstraintFamily:
    fn: Any
    jac_fn: Any
    cone: Cone
    dim: int
    label: str
    knots: np.ndarray
    shared: bool
    constraint: Any = None  # representative Constraint


@dataclasses.dataclass
class _DynamicsFamily:
    fn: Any
    jac_fn: Any
    name: str
    knots: np.ndarray
    shared: bool
    model: Any = None  # representative DiscreteModel


@dataclasses.dataclass(frozen=True)
class ProblemParams:
    """All data of a compiled problem.  `x0` may be [n] or, for a fleet of
    instances, [n, B] (batch last)."""

    x0: Any
    dynamics: tuple
    costs: tuple
    constraints: tuple

    def replace(self, **updates) -> "ProblemParams":
        return dataclasses.replace(self, **updates)

    def astype(self, dtype) -> "ProblemParams":
        """These params with every floating-point leaf cast to `dtype`."""

        def cast(tree):
            if tree is None:
                return None
            if isinstance(tree, dict):
                return {k: cast(v) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return type(tree)(cast(v) for v in tree)
            t = torch.as_tensor(tree)
            return t.to(dtype) if torch.is_floating_point(t) else t

        return ProblemParams(*(cast(getattr(self, f.name)) for f in dataclasses.fields(self)))


class Problem:
    """Trajectory optimization problem over N segments (N+1 knot points).

    Setters mirror `problem.hpp:121-202`; `k` may be an int or an iterable
    of knot indices.
    """

    def __init__(self, N: int):
        if N <= 0:
            raise ValueError("Number of segments must be positive")
        self.N = N
        self._costs: list[Optional[Cost]] = [None] * (N + 1)
        self._dynamics: list[Optional[DiscreteModel]] = [None] * N
        self._constraints: list[list[Constraint]] = [[] for _ in range(N + 1)]
        self._x0 = None

    def set_initial_state(self, x0) -> None:
        self._x0 = torch.as_tensor(x0)

    def set_cost(self, cost: Cost, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N)
            self._costs[i] = cost

    def set_dynamics(self, model: DiscreteModel, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N - 1)
            self._dynamics[i] = model

    def set_constraint(self, con: Constraint, k: KnotSel) -> None:
        for i in _as_knots(k):
            self._check_index(i, self.N)
            self._constraints[i].append(con)

    def _check_index(self, k: int, kmax: int) -> None:
        if not 0 <= k <= kmax:
            raise IndexError(f"Knot index {k} out of range [0, {kmax}]")

    @property
    def n(self) -> int:
        return next(m for m in self._dynamics if m is not None).n

    @property
    def m(self) -> int:
        return next(m for m in self._dynamics if m is not None).m

    def num_constraints(self, k: Optional[int] = None) -> int:
        """Constraint rows at knot k, or in total (`problem.hpp:213-236`)."""
        if k is None:
            return sum(self.num_constraints(i) for i in range(self.N + 1))
        return sum(c.dim for c in self._constraints[k])

    def is_fully_defined(self) -> bool:
        """All knots have costs, all segments dynamics, x0 set
        (`problem.cpp:12-40`)."""
        return (
            self._x0 is not None
            and all(c is not None for c in self._costs)
            and all(d is not None for d in self._dynamics)
        )

    def compile(self) -> "CompiledProblem":
        if not self.is_fully_defined():
            raise ValueError("Problem is not fully defined")
        n, m = self.n, self.m
        for k, model in enumerate(self._dynamics):
            if model.n != n or model.m != m:
                raise ValueError(f"Inconsistent model dimensions at knot {k}")

        cost_fams, cost_params = _group(
            list(enumerate(self._costs)),
            key=lambda c: (c.fn, c.expand_fn),
            make=lambda c, knots, shared: _CostFamily(
                c.fn, c.expand_fn, c.name, knots, shared, cost=c
            ),
        )
        dyn_fams, dyn_params = _group(
            list(enumerate(self._dynamics)),
            key=lambda d: (d.fn, d.jac_fn),
            make=lambda d, knots, shared: _DynamicsFamily(
                d.fn, d.jac_fn, d.name, knots, shared, model=d
            ),
        )
        con_entries = [(k, c) for k, cons in enumerate(self._constraints) for c in cons]
        con_fams, con_params = _group(
            con_entries,
            key=lambda c: (c.fn, c.jac_fn, c.cone, c.dim),
            make=lambda c, knots, shared: _ConstraintFamily(
                c.fn, c.jac_fn, c.cone, c.dim, c.label, knots, shared, constraint=c
            ),
        )
        params = ProblemParams(
            x0=self._x0,
            dynamics=tuple(dyn_params),
            costs=tuple(cost_params),
            constraints=tuple(con_params),
        )
        return CompiledProblem(
            N=self.N,
            n=n,
            m=m,
            cost_families=tuple(cost_fams),
            dynamics_families=tuple(dyn_fams),
            constraint_families=tuple(con_fams),
            params=params,
        )


def _stack_params(objs: list) -> Any:
    """Stack a list of param trees (dicts of tensors, or None) along a new
    leading knot axis."""
    first = objs[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {key: _stack_params([o[key] for o in objs]) for key in first}
    return torch.stack([torch.as_tensor(o) for o in objs])


def param_row(tree, ix):
    """Row `ix` of every leaf of a stacked (per-knot) param tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: param_row(v, ix) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(param_row(v, ix) for v in tree)
    return tree[ix]


def _group(entries, key, make):
    """Group (knot, obj) entries by function identity into families.

    Params are shared when every knot holds the same param object (or the
    same term), else stacked along a leading knot axis.
    """
    families = []
    fam_params = []
    buckets: dict[Any, list[tuple[int, Any]]] = {}
    order: list[Any] = []
    for k, obj in entries:
        kk = key(obj)
        if kk not in buckets:
            buckets[kk] = []
            order.append(kk)
        buckets[kk].append((k, obj))
    for kk in order:
        items = sorted(buckets[kk], key=lambda t: t[0])
        knots = np.asarray([k for k, _ in items], np.int32)
        objs = [o for _, o in items]
        first = objs[0]
        shared = all(o.params is first.params for o in objs) or all(
            o is first for o in objs
        )
        params = first.params if shared else _stack_params([o.params for o in objs])
        families.append(make(first, knots, shared))
        fam_params.append(params)
    return families, fam_params


class CompiledProblem:
    """Static structure of a compiled problem: the function families and the
    initial `ProblemParams`."""

    def __init__(
        self,
        N: int,
        n: int,
        m: int,
        cost_families,
        dynamics_families,
        constraint_families,
        params: ProblemParams,
    ):
        self.N = N
        self.n = n
        self.m = m
        self.cost_families = cost_families
        self.dynamics_families = dynamics_families
        self.constraint_families = constraint_families
        self.params = params
        # per-segment dispatch: segment k runs family dyn_fam_id[k] with
        # that family's params row dyn_idx_in_fam[k] (a stacked family's)
        fam_id = np.zeros(N, np.int32)
        idx_in_fam = np.zeros(N, np.int32)
        for fi, fam in enumerate(dynamics_families):
            fam_id[fam.knots] = fi
            idx_in_fam[fam.knots] = np.arange(len(fam.knots), dtype=np.int32)
        self.dyn_fam_id = fam_id
        self.dyn_idx_in_fam = idx_in_fam

    def dynamics_segment(self, dyn_params: tuple, k: int):
        """(family, params) of segment k: the family `dyn_fam_id[k]` names,
        with its params (a stacked family's row `dyn_idx_in_fam[k]`).  k is
        a host int, so the dispatch is a table lookup, not a switch on the
        device."""
        fj = int(self.dyn_fam_id[k])
        fam = self.dynamics_families[fj]
        fp = dyn_params[fj]
        return fam, (fp if fam.shared else param_row(fp, int(self.dyn_idx_in_fam[k])))

    def dynamics_step(self, dyn_params: tuple, k: int, x, u, t, h):
        """x_{k+1} = f_k(x, u, t, h) with per-segment family dispatch
        (`altro_tpu/problem/problem.py:dynamics_step`)."""
        fam, fp = self.dynamics_segment(dyn_params, k)
        return fam.fn(fp, x, u, t, h)

    def with_dtype(self, dtype) -> "CompiledProblem":
        """The same families with every floating-point param leaf cast to
        `dtype` (`ALSolverBatched` takes its scalar type from the params'
        x0): the float64 copy that `CompactedALSolver`'s polish solves on."""
        return CompiledProblem(self.N, self.n, self.m, self.cost_families, self.dynamics_families,
                               self.constraint_families, self.params.astype(dtype))

    @property
    def num_constraint_rows(self) -> int:
        return sum(f.dim * len(f.knots) for f in self.constraint_families)
