"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference on the host, in the precision and with the
solver options that the cell's limits file names; every gap is taken in
float64.

Fleet cells: each sampled lane that the program reports SOLVED is solved
again by the reference from the same x0, and the program's own X, U are
judged: their gap to the reference's plan, the cost of the program's
trajectory against the reference's, the constraint violation of the
program's trajectory, and how far the program's states depart from the
dynamics under its own controls.

The controller cell: each sampled tick is solved again by the reference
from the measured state and the warm start and AL state the program held
before the tick; the program's control, its shifted warm start and its
carried AL state after the tick are judged against the reference's.  At
the first tick of an episode the state the program starts from is held to
the reference's own start.
"""
from __future__ import annotations

import torch

from ..reference import altro, problem as ref_problem
from ..reference.arith import Arith


def _f64(t):
    return t.detach().to("cpu", torch.float64)


def fleet_numbers(cfg: dict, rec: dict, ref_opts: dict, ar: Arith) -> dict:
    """`rec`: x0 [S, n], X [S, N+1, n], U [S, N, m], solved [S] of the
    sampled lanes."""
    solved = rec["solved"].cpu()
    if not bool(solved.any()):
        return dict(compared_lanes=0)
    x0, X, U = (_f64(rec[k])[solved] for k in ("x0", "X", "U"))
    prob = ref_problem.build(cfg["problem"])
    ref = altro.Solver(prob, ref_opts, ar).solve(x0, prob.initial_controls(x0.shape[0]))
    ref = {k: _f64(v) if torch.is_tensor(v) else v for k, v in ref.items()}
    sol = altro.Solver(prob, ref_opts)
    with torch.no_grad():
        J = sol.base_cost(X, U)
        steps = prob.step(X[:, :-1], U)
        dyn = torch.maximum((X[:, 1:] - steps).abs().amax(dim=(1, 2)), (X[:, 0] - x0).abs().amax(dim=1))
        u_lane = (U - ref["U"]).abs().amax(dim=(1, 2))
        cost_lane = (J - ref["cost"]).abs() / ref["cost"].abs()
        return dict(
            compared_lanes=int(x0.shape[0]),
            u_gap=float(u_lane.max()),
            u_gap_median=float(u_lane.median()),
            x_gap=float((X - ref["X"]).abs().max()),
            cost_gap=float(cost_lane.max()),
            cost_gap_median=float(cost_lane.median()),
            violation=float(sol.violation(X, U).max()),
            dynamics_gap=float(dyn.max()),
            reference_unsolved=int((~((ref["status"] == altro.SOLVED) | (ref["status"] == altro.SOLVED_STALLED))).sum()),
        )


def _al_f64(al):
    return {k: (_f64(l), _f64(r)) for k, (l, r) in al.items()}


def mpc_numbers(cfg: dict, rec: dict, ref_opts: dict, ar: Arith) -> dict:
    """`rec`: per sampled tick and lane: x [S, n], the state before the
    tick (U_in, al_in), the control u [S, m], the state after it (U_out,
    al_out), and first [S] (the episode's first tick)."""
    prob = ref_problem.build(cfg["problem"])
    mpc = altro.MPC(prob, ref_opts, ar)
    x, U_in, al_in = _f64(rec["x"]), _f64(rec["U_in"]), _al_f64(rec["al_in"])
    u_ref, state, _ = mpc.step(dict(U=U_in, al=al_in), x)
    u_ref, state = _f64(u_ref), dict(U=_f64(state["U"]), al=_al_f64(state["al"]))
    al_out, al_ref = _al_f64(rec["al_out"]), state["al"]
    S = x.shape[0]
    # per sampled (tick, lane): the widest gap of its duals, relative to
    # 1 + |λ|, and of its penalties, relative to ρ, over every constraint
    dual_pair, penalty_pair = x.new_zeros(S), x.new_zeros(S)
    for k, (lam, rho) in al_ref.items():
        d = ((al_out[k][0] - lam).abs() / (1.0 + lam.abs())).reshape(S, -1).amax(dim=1)
        r = ((al_out[k][1] - rho).abs() / rho).reshape(S, -1).amax(dim=1)
        dual_pair, penalty_pair = torch.maximum(dual_pair, d), torch.maximum(penalty_pair, r)
    u_pair = (_f64(rec["u"]) - u_ref).abs().amax(dim=1)
    warm_pair = (_f64(rec["U_out"]) - state["U"]).abs().amax(dim=(1, 2))
    out = dict(compared_ticks=int(S), dual_gap=float(dual_pair.max()), penalty_gap=float(penalty_pair.max()))
    # the carried AL state as one number a pair: its duals or its penalties
    for name, pair in (("u_gap", u_pair), ("warm_start_gap", warm_pair),
                       ("al_gap", torch.maximum(dual_pair, penalty_pair))):
        out.update({name: float(pair.max()), f"{name}_median": float(pair.median()),
                    f"{name}_p90": float(torch.quantile(pair, 0.9))})
    first = rec["first"].cpu()
    if bool(first.any()):
        # the reference's start, rounded to the program's precision
        start = mpc.init(int(first.sum()))
        as_run = lambda t: t.to(rec["U_in"].dtype).double()  # noqa: E731
        gap = float((U_in[first] - as_run(start["U"])).abs().max())
        for k, (lam, rho) in start["al"].items():
            gap = max(gap, float((al_in[k][0][first] - as_run(lam)).abs().max()),
                      float((al_in[k][1][first] - as_run(rho)).abs().max()))
        out["start_gap"] = gap
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limited number at or under
    its limit, and something compared."""
    checks = {k: dict(value=numbers.get(k), limit=v) for k, v in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    compared = numbers.get("compared_lanes", numbers.get("compared_ticks", 0))
    return bool(ok and compared > 0), checks
