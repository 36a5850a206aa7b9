"""Structural infeasibility certificates for batched problem fleets
(`altro_tpu/problem/infeasibility.py`).

A sampler of per-instance scenario params can emit layouts whose
constraints cannot all hold, such as an equality goal inside an obstacle.
The solver then spends its whole iteration budget and ends MAX_PENALTY, so
a fleet's solved share mixes solver failures with sampler artifacts.  A
certificate proves such a conflict per instance before the solve.

Certificates are conservative: True is a proof, False is no claim.

* goal in obstacle, same knot: a goal constraint `x_N = xf` and a circle
  constraint active at knot N with `dist(xf_xy, center) < r` cannot both
  hold.
* goal in obstacle, reachability: a circle family active at knot N-1, with
  `step_bound` a bound on how far the state's (x, y) moves in one step
  (v_max·h for the unicycle), and `dist(xf_xy, center) < r − step_bound`
  forces x_{N-1} inside the obstacle too.

`CompactedALSolver(detect_infeasible=True)` computes the mask on the
device before its first phase; certified lanes never iterate and report
`SolverStatus.INFEASIBLE`.
"""
from __future__ import annotations

import torch

__all__ = ["goal_obstacle_certificates"]


def goal_obstacle_certificates(prob, params, B: int, step_bound: float = 0.0) -> torch.Tensor:
    """Per-instance infeasibility mask [B] bool (True = provably infeasible),
    on the device of `params.x0`.

    Parameters
    ----------
    prob : CompiledProblem (its constraint families and their knots).
    params : ProblemParams; each leaf shared or per-instance (a trailing
        batch axis, the `batch_axes` convention).
    B : batch width of the fleet.
    step_bound : one-step (x, y) travel bound that enables the knot-(N-1)
        reachability certificate; 0 keeps the same-knot certificate only.
    """
    N = prob.N
    dev = torch.as_tensor(params.x0).device
    mask = torch.zeros((B,), dtype=torch.bool, device=dev)

    def bcast(leaf):
        # a shared leaf [...] -> [..., B]; a per-instance [..., B] as it is
        leaf = torch.as_tensor(leaf, device=dev)
        if leaf.ndim >= 1 and leaf.shape[-1] == B:
            return leaf
        return leaf[..., None].expand(*leaf.shape, B)

    def structured(kind):
        return [
            (f, params.constraints[i])
            for i, f in enumerate(prob.constraint_families)
            if f.constraint is not None
            and f.constraint.structure is not None
            and f.constraint.structure[0] == kind
        ]

    goals = [(f, p) for f, p in structured("goal") if N in {int(k) for k in f.knots}]
    for _, gp in goals:
        xf = bcast(gp["xf"])  # [n, B]
        for cf, cp in structured("circle"):
            knots = {int(k) for k in cf.knots}
            if N in knots:
                margin = 0.0
            elif (N - 1) in knots and step_bound > 0.0:
                margin = float(step_bound)
            else:
                continue
            _, xi, yi = cf.constraint.structure
            cx, cy, r = bcast(cp["cx"]), bcast(cp["cy"]), bcast(cp["r"])  # [n_obs, B]
            d = torch.sqrt((xf[xi][None, :] - cx) ** 2 + (xf[yi][None, :] - cy) ** 2)
            mask = mask | torch.any(d < r - margin, dim=0)
    return mask
