"""Problem functions of the per-instance solver: costs, expansions,
constraints, rollouts (`altro_tpu/solver/functions.py`).

Where the reference walks N+1 knot-point objects
(`altro/ilqr/ilqr.hpp:350-366`), every family of knot points evaluates as
one `torch.func.vmap` over its knots and scatters its results into stacked
`[N+1, ...]` tensors.  The augmented-Lagrangian terms
(`augmented_lagrangian/al_cost.hpp:264-308`,
`constraints/constraint_values.hpp:111-177`) are added into the same cost
expansion.  Layout: knots first, one instance (X [N+1, n], U [N, m]).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..options import SolverOptions
from ..problem.constraints import (
    Cone,
    cone_is_diagonal,
    cone_jacobian,
    cone_jacobian_diag,
    cone_project,
    cone_project_rows,
    cone_violation,
    dual_cone,
)
from ..problem.costs import ad_expansion
from ..problem.problem import CompiledProblem, ProblemParams
from ..types import Trajectory


@dataclasses.dataclass(frozen=True)
class ConState:
    """Dual and penalty state of one constraint family.

    lam: [nk, p] Lagrange multipliers.  rho: [nk] one penalty per knot (the
    reference sets and scales its per-element penalties uniformly and reads
    element 0, `constraint_values.hpp:44,79,112`).
    """

    lam: torch.Tensor
    rho: torch.Tensor

    def replace(self, **updates) -> "ConState":
        return dataclasses.replace(self, **updates)


ALState = tuple  # tuple[ConState, ...] in constraint-family order


@dataclasses.dataclass(frozen=True)
class Expansions:
    """Stacked cost and dynamics expansions of every knot
    (`ilqr/cost_expansion.hpp:26`, `ilqr/dynamics_expansion.hpp:17`)."""

    costs: torch.Tensor  # [N+1]
    lx: torch.Tensor  # [N+1, n]
    lu: torch.Tensor  # [N+1, m]
    lxx: torch.Tensor  # [N+1, n, n]
    lxu: torch.Tensor  # [N+1, n, m]
    luu: torch.Tensor  # [N+1, m, m]
    A: torch.Tensor  # [N, n, n]
    B: torch.Tensor  # [N, n, m]

    def replace(self, **updates) -> "Expansions":
        return dataclasses.replace(self, **updates)


def _al_value(cone: Cone, c, state: ConState):
    """Rowwise AL penalty (‖Π_{K*}(λ−ρc)‖² − ‖λ‖²)/(2ρ)
    (`constraint_values.hpp:111-119`)."""
    lam_proj = cone_project_rows(dual_cone(cone), state.lam - state.rho[:, None] * c)
    return ((lam_proj * lam_proj).sum(dim=-1) - (state.lam * state.lam).sum(dim=-1)) / (2.0 * state.rho)


def _map_knots(fam, fp, fn, *args):
    """`fn(params, *args)` mapped over a family's knots (the leading axis of
    each of `args`): shared params broadcast, stacked ones map with the
    knots."""
    if fam.shared:
        return vmap(lambda *a: fn(fp, *a))(*args)
    return vmap(fn)(fp, *args)


def _knot_row(fam, knot: int) -> int:
    """Row of knot `knot` within a family's stacked [nk, ...] arrays."""
    rows = np.flatnonzero(np.asarray(fam.knots) == int(knot))
    if rows.size == 0:
        raise IndexError(
            f"constraint {fam.label!r} has no knot {int(knot)} "
            f"(knots {np.asarray(fam.knots).tolist()[:5]}...)"
        )
    return int(rows[0])


class ProblemFunctions:
    """Functions of one compiled problem and options: AL state and
    trajectories go in and come out as explicit values."""

    def __init__(self, prob: CompiledProblem, opts: SolverOptions):
        self.prob = prob
        self.opts = opts
        self._index: dict = {}

    def _knots(self, fam, device):
        """A family's knots as a slice where they are contiguous, else an
        index tensor on `device` (cached)."""
        key = (id(fam), device)
        ks = self._index.get(key)
        if ks is None:
            k = np.asarray(fam.knots)
            if k.size and bool((np.diff(k) == 1).all()):
                ks = slice(int(k[0]), int(k[-1]) + 1)
            else:
                ks = torch.as_tensor(k, dtype=torch.long, device=device)
            self._index[key] = ks
        return ks

    def _family_xu(self, fam, X, U):
        ks = self._knots(fam, X.device)
        return ks, X[ks], U[ks]

    # ---------------------------------------------------------------- al state
    def al_state_init(self, dtype=torch.float64, device=None) -> ALState:
        """Zero duals, initial penalties (`al_solver.hpp:288-302`); on the
        problem's device unless `device` says otherwise."""
        device = self.prob.params.x0.device if device is None else device
        return tuple(
            ConState(
                lam=torch.zeros((len(fam.knots), fam.dim), dtype=dtype, device=device),
                rho=torch.full((len(fam.knots),), self.opts.initial_penalty, dtype=dtype, device=device),
            )
            for fam in self.prob.constraint_families
        )

    def _family_index(self, family) -> int:
        """Resolve a constraint family by index or label."""
        fams = self.prob.constraint_families
        if isinstance(family, str):
            matches = [i for i, f in enumerate(fams) if f.label == family]
            if not matches:
                raise KeyError(f"no constraint family labeled {family!r}; have {[f.label for f in fams]}")
            if len(matches) > 1:
                raise KeyError(f"label {family!r} is ambiguous: {matches}")
            return matches[0]
        i = int(family)
        if not 0 <= i < len(fams):
            raise IndexError(f"constraint family index {i} out of range [0, {len(fams)})")
        return i

    def set_penalty(self, al: ALState, rho: float, family=None, knot=None) -> ALState:
        """Set penalties (`al_solver.hpp:272-277`; per constraint
        `al_cost.hpp:171-231`): every constraint for `family=None`, else one
        family by index or label, and with `knot` one knot of it."""
        if family is None:
            if knot is not None:
                raise ValueError("knot requires a family")
            return tuple(s.replace(rho=torch.full_like(s.rho, rho)) for s in al)
        i = self._family_index(family)
        s = al[i]
        if knot is None:
            s = s.replace(rho=torch.full_like(s.rho, rho))
        else:
            row = _knot_row(self.prob.constraint_families[i], knot)
            r = s.rho.clone()
            r[row] = rho
            s = s.replace(rho=r)
        return al[:i] + (s,) + al[i + 1:]

    def get_penalty(self, al: ALState, family, knot=None):
        """Penalties of one family (`al_cost.hpp:171-200`): [nk], or the
        scalar at `knot`."""
        i = self._family_index(family)
        if knot is None:
            return al[i].rho
        return al[i].rho[_knot_row(self.prob.constraint_families[i], knot)]

    def get_duals(self, al: ALState, family, knot=None):
        """Lagrange multipliers of one family (`al_cost.hpp:204-231`):
        [nk, p], or the [p] row at `knot`."""
        i = self._family_index(family)
        if knot is None:
            return al[i].lam
        return al[i].lam[_knot_row(self.prob.constraint_families[i], knot)]

    def reset_duals(self, al: ALState) -> ALState:
        return tuple(s.replace(lam=torch.zeros_like(s.lam)) for s in al)

    # ------------------------------------------------------------------- costs
    def cost_terms(self, params: ProblemParams, al: ALState, Z: Trajectory):
        """Per-knot total cost (base + AL penalty), [N+1]
        (`ilqr.hpp:758-763`, `al_cost.hpp:264-274`)."""
        X, U = Z.X, Z.upad()
        costs = X.new_zeros((self.prob.N + 1,))
        for fam, fp in zip(self.prob.cost_families, params.costs):
            ks, Xk, Uk = self._family_xu(fam, X, U)
            costs[ks] += _map_knots(fam, fp, fam.fn, Xk, Uk)
        for fam, fp, state in zip(self.prob.constraint_families, params.constraints, al):
            ks, Xk, Uk = self._family_xu(fam, X, U)
            costs[ks] += _al_value(fam.cone, _map_knots(fam, fp, fam.fn, Xk, Uk), state)
        return costs

    def total_cost(self, params, al, Z):
        return self.cost_terms(params, al, Z).sum()

    # -------------------------------------------------------------- expansions
    def expand(self, params: ProblemParams, al: ALState, Z: Trajectory) -> Expansions:
        """Cost and dynamics expansions of every knot, one mapped evaluation
        per family (`ilqr.hpp:670-677` is the per-knot serial analog)."""
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        X, U = Z.X, Z.upad()
        z = X.new_zeros
        costs, lx, lu = z((N + 1,)), z((N + 1, n)), z((N + 1, m))
        lxx, lxu, luu = z((N + 1, n, n)), z((N + 1, n, m)), z((N + 1, m, m))

        def acc(ks, terms):
            for out, t in zip((costs, lx, lu, lxx, lxu, luu), terms):
                out[ks] += t

        for fam, fp in zip(prob.cost_families, params.costs):
            def one(p, x, u, _fam=fam):
                t = (_fam.expand_fn(p, x, u) if _fam.expand_fn is not None
                     else ad_expansion(_fam.fn, p, x, u))
                return t.J, t.lx, t.lu, t.lxx, t.lxu, t.luu

            ks, Xk, Uk = self._family_xu(fam, X, U)
            acc(ks, _map_knots(fam, fp, one, Xk, Uk))
        for fam, fp, state in zip(prob.constraint_families, params.constraints, al):
            ks, Xk, Uk = self._family_xu(fam, X, U)
            acc(ks, self._al_family_expansion(fam, fp, state, Xk, Uk))
        A, B = self._dynamics_expansion(params, Z)
        return Expansions(costs=costs, lx=lx, lu=lu, lxx=lxx, lxu=lxu, luu=luu, A=A, B=B)

    def _al_family_expansion(self, fam, fp, state: ConState, Xk, Uk):
        """AL value, gradient and Gauss-Newton Hessian of one constraint
        family over its knots' Xk, Uk (`ConstraintValues::AugLag*`,
        `constraint_values.hpp:111-177`); the second-order cone with its
        dense projection Jacobian."""
        dual = dual_cone(fam.cone)
        jac = fam.jac_fn if fam.jac_fn is not None else jacfwd(fam.fn, argnums=(1, 2))

        def one(p, x, u, lam, rho):
            c = fam.fn(p, x, u)
            Cx, Cu = jac(p, x, u)
            s = lam - rho * c
            lam_proj = cone_project(dual, s)
            J = (lam_proj @ lam_proj - lam @ lam) / (2.0 * rho)
            if cone_is_diagonal(dual):
                dproj = cone_jacobian_diag(dual, s)
                Jpx = dproj[:, None] * Cx
                Jpu = dproj[:, None] * Cu
            else:
                Jp = cone_jacobian(dual, s)
                Jpx = Jp @ Cx
                Jpu = Jp @ Cu
            return (J, -(Jpx.T @ lam_proj), -(Jpu.T @ lam_proj),
                    rho * (Jpx.T @ Jpx), rho * (Jpx.T @ Jpu), rho * (Jpu.T @ Jpu))

        if fam.shared:
            return vmap(lambda x, u, lam, rho: one(fp, x, u, lam, rho))(Xk, Uk, state.lam, state.rho)
        return vmap(one)(fp, Xk, Uk, state.lam, state.rho)

    def _dynamics_expansion(self, params: ProblemParams, Z: Trajectory):
        """Discrete Jacobians A [N,n,n], B [N,n,m] by forward-mode AD of each
        family's step over its knots (`dynamics_expansion.hpp:42-47`,
        `integration.hpp:132-169`)."""
        prob = self.prob
        X = Z.X
        A = X.new_zeros((prob.N, prob.n, prob.n))
        B = X.new_zeros((prob.N, prob.n, prob.m))
        for fam, fp in zip(prob.dynamics_families, params.dynamics):
            ks = self._knots(fam, X.device)
            jac = fam.jac_fn if fam.jac_fn is not None else jacfwd(fam.fn, argnums=(1, 2))
            A[ks], B[ks] = _map_knots(fam, fp, jac, X[ks], Z.U[ks], Z.t[ks], Z.h[ks])
        return A, B

    # ------------------------------------------------------------- constraints
    def constraint_values(self, params: ProblemParams, Z: Trajectory):
        """Constraint values per family, a tuple of [nk, p]."""
        X, U = Z.X, Z.upad()
        out = []
        for fam, fp in zip(self.prob.constraint_families, params.constraints):
            _, Xk, Uk = self._family_xu(fam, X, U)
            out.append(_map_knots(fam, fp, fam.fn, Xk, Uk))
        return tuple(out)

    def max_violation(self, cvals):
        """∞-norm violation over all constraints and knots
        (`al_solver.hpp:417-424`)."""
        if not cvals:
            return torch.zeros(())
        viol = cvals[0].new_zeros(())
        for fam, c in zip(self.prob.constraint_families, cvals):
            viol = torch.maximum(viol, cone_violation(fam.cone, c).max())
        return viol

    def max_penalty(self, al: ALState):
        """Largest penalty over the constraints (`al_solver.hpp:427-434`)."""
        if not al:
            return torch.zeros(())
        pen = al[0].rho.new_zeros(())
        for s in al:
            pen = torch.maximum(pen, s.rho.max())
        return pen

    def update_duals(self, al: ALState, cvals) -> ALState:
        """λ ← Π_{K*}(λ − ρ∘c) (`constraint_values.hpp:192-194`)."""
        return tuple(
            s.replace(lam=cone_project_rows(dual_cone(fam.cone), s.lam - s.rho[:, None] * c))
            for fam, s, c in zip(self.prob.constraint_families, al, cvals)
        )

    def update_penalties(self, al: ALState) -> ALState:
        """ρ ← φρ, the geometric increase (`constraint_values.hpp:202-207`)."""
        phi = self.opts.penalty_scaling
        return tuple(s.replace(rho=s.rho * phi) for s in al)

    # ---------------------------------------------------------------- rollouts
    def rollout(self, params: ProblemParams, Z: Trajectory) -> Trajectory:
        """Open-loop rollout from the problem's initial state
        (`ilqr.hpp:453-459`)."""
        prob = self.prob
        x = torch.as_tensor(params.x0).to(Z.X.dtype)
        X = [x]
        for k in range(prob.N):
            x = prob.dynamics_step(params.dynamics, k, x, Z.U[k], Z.t[k], Z.h[k])
            X.append(x)
        return Z.replace(X=torch.stack(X))
