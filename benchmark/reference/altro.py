"""Plain AL-iLQR: the augmented-Lagrangian iterative LQR of altro-cpp
(`altro/augmented_lagrangian/al_solver.hpp`, `altro/ilqr/ilqr.hpp`), run
on many independent problems at once.

Every tensor has the lanes first: X [S, N+1, n], U [S, N, m], gains
K [S, N, m, n].  Each lane follows the algorithm alone; a lane that is done
stops changing while the others iterate.  The backward pass is the
sequential Riccati recursion with altro-cpp's regularization schedule, the
forward pass its backtracking line search with the improvement-ratio test,
the outer loop its dual and penalty updates, with the stall exit that the
program's options add (`max_stall_iterations`).  The costs are tracking
costs; each kind of constraint (`constraints/<kind>.py`) gives its rows'
values and augmented-Lagrangian terms at the stage knots 0..N-1 or at the
terminal knot, and this file does the rest alike for every kind.  Dynamics
Jacobians are forward-mode derivatives of the RK4 step.  The arithmetic
(scalar type, matrix products, the m×m factorization) comes from `Arith`.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from . import constraints as kinds
from .arith import Arith, cholesky, cholesky_solve
from .problem import Problem

# altro-cpp's SolverStatus codes (`altro/common/solver_stats.hpp`) and the
# stall exit's own
SOLVED, UNSOLVED, STATE_LIMIT, CONTROL_LIMIT, COST_INCREASE = 0, 1, 2, 3, 4
MAX_ITERATIONS, MAX_OUTER, MAX_INNER, MAX_PENALTY, BP_FAILED = 5, 6, 7, 8, 9
SOLVED_STALLED = 10

# altro-cpp's defaults (`altro/common/solver_options.hpp:23-54`) and the
# options the program adds
DEFAULTS = dict(
    max_iterations_total=300, max_iterations_outer=30, max_iterations_inner=100,
    cost_tolerance=1e-4, gradient_tolerance=1e-2,
    bp_reg_increase_factor=1.6, bp_reg_initial=0.0, bp_reg_max=1e8, bp_reg_min=1e-8,
    bp_reg_fail_threshold=100, bp_gain_limit=1e8,
    check_forwardpass_bounds=True, state_max=1e8, control_max=1e8,
    line_search_max_iterations=20, line_search_lower_bound=1e-8, line_search_upper_bound=10.0,
    line_search_decrease_factor=2.0,
    constraint_tolerance=1e-4, maximum_penalty=1e8, initial_penalty=1.0, penalty_scaling=10.0,
    reset_duals=True, max_stall_iterations=10, stalled_feasible_exits=True,
    update_duals_on_failed_inner=True,
)


def options(**over) -> dict:
    unknown = set(over) - set(DEFAULTS)
    if unknown:
        raise KeyError(f"unknown solver options {sorted(unknown)}")
    return {**DEFAULTS, **over}


def _increase(rho, drho, o):
    drho = torch.clamp(drho * o["bp_reg_increase_factor"], min=o["bp_reg_increase_factor"])
    return torch.clamp(rho * drho, o["bp_reg_min"], o["bp_reg_max"]), drho


def _decrease(rho, drho, o):
    drho = torch.clamp(drho / o["bp_reg_increase_factor"], max=1.0 / o["bp_reg_increase_factor"])
    return torch.clamp(rho * drho, o["bp_reg_min"], o["bp_reg_max"]), drho


def _sel(mask, a, b):
    """where(mask [S], a, b) for tensors with the lanes first."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


class Solver:
    def __init__(self, prob: Problem, opts: dict, ar: Arith | None = None, device="cpu"):
        self.ar = ar or Arith(torch.float64)
        self.p = prob.to(self.ar.dtype, device)
        self.o = opts
        self.device = torch.device(device)
        p = self.p
        self._jac = vmap(jacfwd(lambda x, u: p.step(x, u), argnums=(0, 1)))
        self._eye_m = torch.eye(p.m, dtype=self.ar.dtype, device=self.device)

    # ------------------------------------------------------------ AL state
    def _kinds(self):
        """(name, module, data) of each constraint kind of the problem."""
        return [(k, kinds.kind(k), data) for k, data in self.p.constraints.items()]

    @staticmethod
    def _at(mod, X, U):
        """A kind's arguments: (x_k, u_k) at the stage knots, or (x_N, None)."""
        return (X[:, :-1], U) if mod.KNOTS == "stage" else (X[:, -1], None)

    def al_init(self, S: int) -> dict:
        p, dt, dev, r0 = self.p, self.ar.dtype, self.device, self.o["initial_penalty"]
        al = {}
        for k, mod, data in self._kinds():
            knots = (p.N,) if mod.KNOTS == "stage" else ()
            al[k] = (torch.zeros((S, *knots, mod.rows(data, p.n, p.m)), dtype=dt, device=dev),
                     torch.full((S, *knots), r0, dtype=dt, device=dev))
        return al

    def constraints(self, X, U) -> dict:
        """Constraint values of each kind: [S, N, rows] at the stage knots,
        [S, rows] at the terminal one."""
        return {k: mod.value(data, *self._at(mod, X, U)) for k, mod, data in self._kinds()}

    def violation(self, X, U) -> torch.Tensor:
        """∞-norm violation per lane (`al_solver.hpp:417-424`)."""
        v = X.new_zeros(X.shape[0])
        for k, mod, data in self._kinds():
            c = mod.value(data, *self._at(mod, X, U))
            c = c.abs() if mod.EQUALITY else torch.clamp(c, min=0.0)
            v = torch.maximum(v, c.reshape(c.shape[0], -1).amax(dim=1))
        return v

    # --------------------------------------------------------------- costs
    def base_costs(self, X, U):
        """Per-knot tracking costs: stage [S, N], terminal [S]."""
        p, ar = self.p, self.ar
        dx, du = X[:, :-1] - p.xf, U - p.uref
        stage = 0.5 * ar.quad(p.Q, dx) + 0.5 * ar.quad(p.R, du)
        dxf = X[:, -1] - p.xf
        return stage, 0.5 * ar.quad(p.Qf, dxf)

    def base_cost(self, X, U) -> torch.Tensor:
        stage, term = self.base_costs(X, U)
        return stage.sum(dim=1) + term

    def _al_terms(self, X, U, al):
        """(kind's module, its AL cost per lane, its expansion terms) of
        each kind."""
        out = []
        for k, mod, data in self._kinds():
            J, terms = mod.al_terms(data, *self._at(mod, X, U), *al[k])
            out.append((mod, J.sum(dim=1) if mod.KNOTS == "stage" else J, terms))
        return out

    def total_cost(self, X, U, al) -> torch.Tensor:
        stage, term = self.base_costs(X, U)
        J = stage.sum(dim=1) + term
        for _, Jk, _ in self._al_terms(X, U, al):
            J = J + Jk
        return J

    # ---------------------------------------------------------- expansions
    def expand(self, X, U, al) -> dict:
        p, ar = self.p, self.ar
        S, N, n, m = X.shape[0], p.N, p.n, p.m
        dx, du = X[:, :-1] - p.xf, U - p.uref
        e = dict(lx=ar.mv(p.Q, dx), lu=ar.mv(p.R, du), lxx=p.Q.expand(S, N, n, n), luu=p.R.expand(S, N, m, m),
                 lxN=ar.mv(p.Qf, X[:, -1] - p.xf), lxxN=p.Qf.expand(S, n, n))
        J0 = self.total_cost(X, U, al)
        for mod, _, terms in self._al_terms(X, U, al):
            for key, v in terms.items():
                key = key if mod.KNOTS == "stage" else key + "N"
                e[key] = e[key] + v
        A, B = self._jac(X[:, :-1].reshape(S * N, n), U.reshape(S * N, m))
        return dict(e, A=A.reshape(S, N, n, n), B=B.reshape(S, N, n, m), J0=J0)

    # -------------------------------------------------------- backward pass
    def sweep(self, e, rho):
        """One Riccati sweep at regularization ρ [S] (`ilqr.hpp:385-445`,
        `knot_point_function_type.hpp:149-235`).  After a lane's first
        failed knot its carry stays frozen.  Returns (K, d, dV1, dV2,
        failed)."""
        ar, o = self.ar, self.o
        S, N = rho.shape[0], self.p.N
        P, pv = e["lxxN"], e["lxN"]
        dV1 = rho.new_zeros(S)
        dV2 = rho.new_zeros(S)
        failed = torch.zeros(S, dtype=torch.bool, device=rho.device)
        Ks, ds = [None] * N, [None] * N
        for k in reversed(range(N)):
            A, B = e["A"][:, k], e["B"][:, k]
            At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
            AtP = ar.mm(At, P)
            Qxx = e["lxx"][:, k] + ar.mm(AtP, A)
            Qxu = ar.mm(AtP, B)
            Quu = e["luu"][:, k] + ar.mm(Bt, ar.mm(P, B))
            Qx = e["lx"][:, k] + ar.mv(At, pv)
            Qu = e["lu"][:, k] + ar.mv(Bt, pv)
            L, fail_k = cholesky(Quu + rho[:, None, None] * self._eye_m)
            L = torch.where(torch.isfinite(L), L, torch.ones_like(L))
            sol = -cholesky_solve(L, torch.cat([Qxu.transpose(-1, -2), Qu[..., None]], dim=-1))
            K, d = sol[..., :-1], sol[..., -1]
            fail_k = fail_k | ~(sol.abs().amax(dim=(1, 2)) <= o["bp_gain_limit"])
            Kt = K.transpose(-1, -2)
            KtQuu = ar.mm(Kt, Quu)
            p_new = Qx + ar.mv(KtQuu, d) + ar.mv(Kt, Qu) + ar.mv(Qxu, d)
            P_new = Qxx + ar.mm(KtQuu, K) + ar.mm(Kt, Qxu.transpose(-1, -2)) + ar.mm(Qxu, K)
            failed = failed | fail_k
            dV1 = torch.where(failed, dV1, dV1 + (d * Qu).sum(-1))
            dV2 = torch.where(failed, dV2, dV2 + 0.5 * (d * ar.mv(Quu, d)).sum(-1))
            P = _sel(failed, P, P_new)
            pv = _sel(failed, pv, p_new)
            Ks[k], ds[k] = K, d
        return torch.stack(Ks, dim=1), torch.stack(ds, dim=1), dV1, dV2, failed

    def backward(self, e, rho, drho, active):
        """The sweep with the regularization retry loop: ρ rises on the
        lanes that failed until each passes or gives up."""
        o = self.o
        count = torch.zeros_like(rho, dtype=torch.int32)
        while True:
            K, d, dV1, dV2, failed = self.sweep(e, rho)
            rho2, drho2 = _increase(rho, drho, o)
            rho = torch.where(failed, rho2, rho)
            drho = torch.where(failed, drho2, drho)
            count = count + (failed & (rho >= o["bp_reg_max"])).to(torch.int32)
            give_up = failed & (count >= o["bp_reg_fail_threshold"])
            if not bool((active & failed & ~give_up).any()):
                return dict(K=K, d=d, dV1=dV1, dV2=dV2, failed=failed, rho=rho, drho=drho)

    # --------------------------------------------------------- forward pass
    def rollout(self, x0, U):
        xs = [x0]
        for k in range(self.p.N):
            xs.append(self.p.step(xs[-1], U[:, k]))
        return torch.stack(xs, dim=1)

    def closed_loop(self, x0, X, U, K, d, alpha):
        """ū = u + K(x̄ − x) + αd with the divergence guards
        (`ilqr.hpp:468-499`).  Returns (X̄, Ū, valid, status)."""
        o, ar = self.o, self.ar
        S = x0.shape[0]
        xbar = x0
        valid = torch.ones(S, dtype=torch.bool, device=x0.device)
        status = torch.full((S,), UNSOLVED, dtype=torch.int32, device=x0.device)
        xs, us = [x0], []
        for k in range(self.p.N):
            ubar = U[:, k] + ar.mv(K[:, k], xbar - X[:, k]) + alpha[:, None] * d[:, k]
            xn = self.p.step(xbar, ubar)
            if o["check_forwardpass_bounds"]:
                s_ok = torch.sqrt((xn * xn).sum(-1)) <= o["state_max"]
                c_ok = torch.sqrt((ubar * ubar).sum(-1)) <= o["control_max"]
                ok = s_ok & c_ok
                status = torch.where(valid & ~ok, torch.where(s_ok, CONTROL_LIMIT, STATE_LIMIT), status).to(torch.int32)
                valid = valid & ok
                xbar = _sel(valid, xn, xbar)
            else:
                xbar = xn
            xs.append(xbar)
            us.append(ubar)
        status = torch.where(valid, UNSOLVED, status).to(torch.int32)
        return torch.stack(xs, dim=1), torch.stack(us, dim=1), valid, status

    def line_search(self, x0, X, U, al, bp, J0, active):
        """Backtracking search with the improvement-ratio test
        (`ilqr.hpp:512-558`), α halved after each rejection."""
        o = self.o
        S = x0.shape[0]
        it = torch.zeros(S, dtype=torch.int32, device=x0.device)
        alpha = torch.ones_like(J0)
        success = torch.zeros(S, dtype=torch.bool, device=x0.device)
        J, z = J0, -torch.ones_like(J0)
        status = torch.full((S,), UNSOLVED, dtype=torch.int32, device=x0.device)
        Xb, Ub = X, U
        mx = o["line_search_max_iterations"]
        more = mx > 0
        while more:
            a = (~success) & (it < mx)
            Xt, Ut, valid, st = self.closed_loop(x0, X, U, bp["K"], bp["d"], alpha)
            Jt = self.total_cost(Xt, Ut, al)
            Jv = torch.where(valid, Jt, J)
            expected = -alpha * (bp["dV1"] + alpha * bp["dV2"])
            zt = torch.where(expected > 0.0, (J0 - Jt) / expected, -torch.ones_like(J0))
            ok = valid & (o["line_search_lower_bound"] <= zt) & (zt <= o["line_search_upper_bound"]) & (Jt < J0)
            it = it + a.to(torch.int32)
            success = torch.where(a, ok, success)
            alpha = torch.where(a & ~ok, alpha / o["line_search_decrease_factor"], alpha)
            J, z = torch.where(a, Jv, J), torch.where(a, zt, z)
            status = torch.where(a, st, status)
            Xb, Ub = _sel(a, Xt, Xb), _sel(a, Ut, Ub)
            more = bool((active & ~success & (it < mx)).any())
        return dict(X=Xb, U=Ub, J=J, alpha=alpha, z=z, success=success, status=status)

    # ---------------------------------------------------------------- iLQR
    def ilqr(self, x0, X, U, al, st, outer_active):
        """The inner solve of the lanes in `outer_active`; `st` holds each
        lane's iteration counts, which carry across outer iterations."""
        o = self.o
        S = x0.shape[0]
        dev = x0.device
        X = _sel(outer_active, self.rollout(x0, U), X)
        J_init = self.total_cost(X, U, al)
        st["inner"] = torch.where(outer_active, 0, st["inner"])
        rho = torch.full((S,), o["bp_reg_initial"], dtype=X.dtype, device=dev)
        drho = torch.zeros_like(rho)
        cost_last = J_init
        status = torch.full((S,), UNSOLVED, dtype=torch.int32, device=dev)
        done = ~outer_active
        stall = torch.zeros(S, dtype=torch.int32, device=dev)
        while bool((~done).any()):
            active = ~done
            e = self.expand(X, U, al)
            bp = self.backward(e, rho, drho, active)
            rho_d, drho_d = _decrease(bp["rho"], bp["drho"], o)
            fp = self.line_search(x0, X, U, al, bp, e["J0"], active)
            Xn = _sel(fp["success"], fp["X"], X)
            Un = _sel(fp["success"], fp["U"], U)
            rho_i, drho_i = _increase(rho_d, drho_d, o)
            rho_n = torch.where(fp["success"], rho_d, rho_i)
            drho_n = torch.where(fp["success"], drho_d, drho_i)
            J_fin = torch.where(fp["success"], fp["J"], e["J0"])
            s_fp = torch.where(J_fin > e["J0"], COST_INCREASE, fp["status"])
            s_it = torch.where(bp["failed"], BP_FAILED, s_fp).to(torch.int32)
            cost_new = torch.where(fp["success"], fp["J"], cost_last)
            grad = (bp["d"].abs() / (Un.abs() + 1.0)).amax(dim=2).mean(dim=1)
            dJ = cost_last - cost_new
            step = active.to(torch.int32)
            inner, total = st["inner"] + step, st["total"] + step
            small = dJ < o["cost_tolerance"]
            converged = small & (grad < o["gradient_tolerance"])
            stall = torch.where(active & small, stall + 1, torch.where(active, 0, stall)).to(torch.int32)
            if o["max_stall_iterations"] > 0:
                stalled = (stall >= o["max_stall_iterations"]) & ~converged
            else:
                stalled = torch.zeros_like(converged)
            hit_inner = inner >= o["max_iterations_inner"]
            hit_total = total >= o["max_iterations_total"]
            bad = s_it != UNSOLVED
            s_it = torch.where(converged, SOLVED, torch.where(stalled, SOLVED_STALLED, torch.where(
                hit_inner, MAX_INNER, torch.where(hit_total, MAX_ITERATIONS, s_it)))).to(torch.int32)
            done_new = converged | stalled | hit_inner | hit_total | bad
            st["inner"] = torch.where(active, inner, st["inner"])
            st["total"] = torch.where(active, total, st["total"])
            st["cost"] = torch.where(active, cost_new, st["cost"])
            X, U = _sel(active, Xn, X), _sel(active, Un, U)
            rho, drho = torch.where(active, rho_n, rho), torch.where(active, drho_n, drho)
            cost_last = torch.where(active, cost_new, cost_last)
            status = torch.where(active, s_it, status)
            done = done | (active & done_new)
        return X, U, status

    # ------------------------------------------------------------- AL outer
    @torch.no_grad()
    def solve(self, x0, U0, al=None) -> dict:
        """Solve every lane from x0 [S, n] and the initial controls
        U0 [S, N, m].  `al` warm-starts the duals and penalties under the
        options `reset_duals` and `initial_penalty`
        (`al_solver.hpp:288-302`).  Returns X, U, status, the iteration
        counts, the AL state and the cost with and without its AL terms."""
        o = self.o
        dt, dev = self.ar.dtype, self.device
        x0, U = x0.to(dt), U0.to(dt)
        S = x0.shape[0]
        if al is None:
            al = self.al_init(S)
        else:
            if o["reset_duals"]:
                al = {k: (torch.zeros_like(l), r) for k, (l, r) in al.items()}
            if o["initial_penalty"] > 0:
                al = {k: (l, torch.full_like(r, o["initial_penalty"])) for k, (l, r) in al.items()}
        st = dict(inner=torch.zeros(S, dtype=torch.int32, device=dev),
                  total=torch.zeros(S, dtype=torch.int32, device=dev),
                  outer=torch.zeros(S, dtype=torch.int32, device=dev),
                  cost=torch.zeros(S, dtype=dt, device=dev))
        X = self.rollout(x0, U)
        status = torch.full((S,), UNSOLVED, dtype=torch.int32, device=dev)
        done = torch.zeros(S, dtype=torch.bool, device=dev)
        while bool((~done).any()):
            active = ~done
            X2, U2, s_in = self.ilqr(x0, X, U, al, st, active)
            inner_solved = s_in == SOLVED
            inner_ok = inner_solved | (s_in == SOLVED_STALLED)
            upd = active if o["update_duals_on_failed_inner"] else (active & inner_ok)
            c = self.constraints(X2, U2)
            al_new = {}
            for k, mod, _ in self._kinds():
                lam, rho = al[k]
                lam_n = lam - rho[..., None] * c[k]
                lam_n = lam_n if mod.EQUALITY else torch.clamp(lam_n, max=0.0)
                al_new[k] = (_sel(upd, lam_n, lam), rho)
            viol = self.violation(X2, U2)
            pen = torch.zeros_like(viol)
            for _, r in al_new.values():
                pen = torch.maximum(pen, r.reshape(S, -1).amax(dim=1))
            st["outer"] = torch.where(active, st["outer"] + 1, st["outer"])
            sat = viol < o["constraint_tolerance"]
            pen_hi = pen > o["maximum_penalty"]
            outer_hi = st["outer"] >= o["max_iterations_outer"]
            total_hi = st["total"] >= o["max_iterations_total"]
            sat_done = sat if o["stalled_feasible_exits"] else (sat & inner_solved)
            s = torch.where(~inner_ok, s_in, torch.where(
                sat_done, torch.where(inner_solved, SOLVED, SOLVED_STALLED),
                torch.where(pen_hi, MAX_PENALTY, torch.where(
                    outer_hi, MAX_OUTER, torch.where(total_hi, MAX_ITERATIONS, UNSOLVED))))).to(torch.int32)
            if not o["stalled_feasible_exits"]:
                capped = pen_hi | outer_hi | total_hi
                s = torch.where(inner_ok & sat & ~sat_done & capped, SOLVED_STALLED, s).to(torch.int32)
            done_new = (~inner_ok) | sat_done | pen_hi | outer_hi | total_hi
            cont = active & ~done_new
            al_next = {}
            for k, (lam, rho) in al_new.items():
                grow = cont.reshape((S,) + (1,) * (rho.dim() - 1))
                al_next[k] = (lam, torch.where(grow, rho * o["penalty_scaling"], rho))
            al = {k: (_sel(active, al_next[k][0], al[k][0]), _sel(active, al_next[k][1], al[k][1])) for k in al}
            X, U = _sel(active, X2, X), _sel(active, U2, U)
            status = torch.where(active, s, status)
            done = done | (active & done_new)
        return dict(X=X, U=U, status=status, iterations_total=st["total"], iterations_outer=st["outer"],
                    al=al, cost=self.base_cost(X, U), cost_al=self.total_cost(X, U, al))


class MPC:
    """Warm-started receding-horizon control of many vehicles: each tick
    one capped solve from the measured states, the duals carried, the
    penalties restarted at `initial_penalty` (`reset_duals` off), and the
    controls shifted one knot for the next tick (the last one repeated).
    The states of the guess are never read: each solve rolls out from the
    measured state."""

    def __init__(self, prob: Problem, opts: dict, ar: Arith | None = None, device="cpu"):
        self.solver = Solver(prob, {**opts, "reset_duals": False}, ar, device)

    def init(self, S: int) -> dict:
        s = self.solver
        return dict(U=s.p.initial_controls(S), al=s.al_init(S))

    def step(self, state: dict, x):
        res = self.solver.solve(x, state["U"], state["al"])
        U = res["U"]
        return U[:, 0], dict(U=torch.cat([U[:, 1:], U[:, -1:]], dim=1), al=res["al"]), res["status"]
