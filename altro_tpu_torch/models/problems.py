"""Canned benchmark problems (`altro_tpu/models/problems.py`).

`UnicycleProblem`, turn-90 parking scenario (`examples/problems/unicycle.cpp:
11-89`), with the reference's horizon, weights, bounds and initial guess so
its golden values apply.  The three-obstacle scenario is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem.constraints import control_bound, goal_constraint
from ..problem.costs import lqr_cost
from ..problem.problem import Problem
from ..types import Trajectory, initial_trajectory
from .unicycle import unicycle_rk4

TURN90 = "turn90"


@dataclasses.dataclass
class UnicycleProblem:
    """Unicycle parking benchmark (`examples/problems/unicycle.hpp:26-122`)."""

    scenario: str = TURN90
    N: int = 100
    dtype: torch.dtype = torch.float64
    device: torch.device | str = "cpu"

    def __post_init__(self):
        if self.scenario != TURN90:
            raise ValueError(f"Unknown or unported scenario {self.scenario!r}")
        self.n = 3
        self.m = 2
        self.v_bnd = 1.5
        self.w_bnd = 1.5
        self.tf = 3.0
        # the reference computes h = tf/N in float32 (`unicycle.hpp:79`)
        h = float(np.float32(self.tf) / np.float32(self.N))
        self.h = h
        self.Q = np.eye(3) * (1e-2 * h)
        self.R = np.eye(2) * (1e-2 * h)
        self.Qf = np.eye(3) * 100.0
        self.x0 = np.zeros(3)
        self.xf = np.array([1.5, 1.5, np.pi / 2])
        self.u0 = np.full(2, 0.1)
        self.lb = np.array([-self.v_bnd, -self.w_bnd])
        self.ub = np.array([+self.v_bnd, +self.w_bnd])
        self.uref = np.zeros(2)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def make_problem(self, add_constraints: bool = True) -> Problem:
        N = self.N
        prob = Problem(N)
        stage = lqr_cost(
            self._t(self.Q), self._t(self.R), self._t(self.xf), self._t(self.uref)
        )
        term = lqr_cost(
            self._t(self.Qf), self._t(np.zeros((2, 2))), self._t(self.xf),
            self._t(self.uref), terminal=True,
        )
        prob.set_cost(stage, range(N))
        prob.set_cost(term, N)
        prob.set_dynamics(unicycle_rk4(), range(N))
        if add_constraints:
            prob.set_constraint(
                control_bound(self._t(self.lb), self._t(self.ub)), range(N)
            )
            prob.set_constraint(goal_constraint(self._t(self.xf)), N)
        prob.set_initial_state(self._t(self.x0))
        return prob

    def initial_trajectory(self) -> Trajectory:
        return initial_trajectory(
            self.n, self.m, self.N, self.h, u0=self.u0,
            dtype=self.dtype, device=self.device,
        )
