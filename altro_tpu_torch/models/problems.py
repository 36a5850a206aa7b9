"""Canned benchmark problems (`altro_tpu/models/problems.py`).

`UnicycleProblem`, scenarios kTurn90 (parking) and kThreeObstacles
(`examples/problems/unicycle.cpp:11-89`), and `TripleIntegratorProblem` (`examples/problems/
triple_integrator.hpp:22-105`), with the reference's horizon, weights,
bounds and initial guess so its golden values apply; the model zoo's
fleet problems `zoo_quadrotor` and `zoo_cartpole` (`perf/benchmark_zoo.py:
54-97`); the randomized three-obstacle fleet's per-lane params
(`randomized_fleet`, `perf/benchmark_randomized.py:48-93`); and the JAX
package's general batched problems, which no fused kernel takes: the
velocity-cone unicycle (`soc_unicycle`, tests/test_batched_soc.py:54-75),
the hybrid triple-integrator / damped system (`hybrid_triple_integrator`)
and the damping schedule of per-knot dynamics params (`damping_schedule`,
tests/test_batched_heterogeneous.py:35-61, 90-156), each at any dof.  All
build their tensors on the card unless `device` says otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem.constraints import Cone, Constraint, circle_constraint, control_bound, goal_constraint
from ..problem.costs import lqr_cost
from ..problem.dynamics import ContinuousModel, discretize
from ..problem.problem import Problem
from ..types import Trajectory, default_device, initial_trajectory
from .cartpole import cartpole_rk4
from .quadrotor import hover_controls, hover_state, quadrotor_rk4
from .triple_integrator import triple_integrator_rk4
from .unicycle import unicycle_rk4

TURN90 = "turn90"
THREE_OBSTACLES = "three_obstacles"


@dataclasses.dataclass
class UnicycleProblem:
    """Unicycle parking / obstacle-avoidance benchmark
    (`examples/problems/unicycle.hpp:26-122`)."""

    scenario: str = TURN90
    N: int = 100
    dtype: torch.dtype = torch.float64
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = default_device(self.device)
        self.n = 3
        self.m = 2
        self.v_bnd = 1.5
        self.w_bnd = 1.5
        if self.scenario == TURN90:
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
            self.obstacles = None
        elif self.scenario == THREE_OBSTACLES:
            self.tf = 5.0
            h = float(np.float32(self.tf) / np.float32(self.N))
            self.h = h
            self.Q = np.eye(3) * (1.0 * h)
            self.R = np.eye(2) * (0.5 * h)
            self.Qf = np.eye(3) * 10.0
            self.x0 = np.zeros(3)
            self.xf = np.array([3.0, 3.0, 0.0])
            self.u0 = np.full(2, 0.01)
            self.lb = np.array([0.0, -3.0])
            self.ub = np.array([3.0, +3.0])
            scaling = 3.0
            self.obstacles = (
                np.array([0.25, 0.5, 0.75]) * scaling,  # cx
                np.array([0.25, 0.5, 0.75]) * scaling,  # cy
                np.full(3, 0.425),  # radii
            )
        else:
            raise ValueError(f"Unknown scenario {self.scenario!r}")
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
        if self.obstacles is not None:
            cx, cy, cr = self.obstacles
            obs = circle_constraint(self._t(cx), self._t(cy), self._t(cr))
            prob.set_constraint(obs, range(1, N))  # `unicycle.cpp:54-58`
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


@dataclasses.dataclass
class TripleIntegratorProblem:
    """Triple-integrator benchmark (`examples/problems/triple_integrator.hpp:22-105`)."""

    dof: int = 2
    N: int = 10
    h: float = 0.1
    dtype: torch.dtype = torch.float64
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = default_device(self.device)
        dof = self.dof
        self.n = 3 * dof
        self.m = dof
        self.Q = np.eye(self.n) * 1.0
        self.R = np.eye(self.m) * 0.001
        self.Qf = np.eye(self.n) * 1e5
        self.xf = np.zeros(self.n)
        self.x0 = np.zeros(self.n)
        self.ubnd = np.zeros(dof)
        for i in range(dof):
            self.xf[i] = i + 1
            self.x0[i] = -(i + 1)
            self.ubnd[i] = 100 * (i + 1)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def make_problem(self, add_constraints: bool = False) -> Problem:
        N, m = self.N, self.m
        prob = Problem(N)
        stage = lqr_cost(self._t(self.Q), self._t(self.R), self._t(self.xf), self._t(np.zeros(m)))
        term = lqr_cost(
            self._t(self.Qf), self._t(np.zeros((m, m))), self._t(self.xf), self._t(np.zeros(m)),
            terminal=True,
        )
        prob.set_cost(stage, range(N))
        prob.set_cost(term, N)
        prob.set_dynamics(triple_integrator_rk4(self.dof), range(N))
        if add_constraints:
            prob.set_constraint(control_bound(self._t(-self.ubnd), self._t(self.ubnd)), range(N))
            prob.set_constraint(goal_constraint(self._t(self.xf)), N)
        prob.set_initial_state(self._t(self.x0))
        return prob

    def initial_trajectory(self) -> Trajectory:
        return initial_trajectory(
            self.n, self.m, self.N, self.h, dtype=self.dtype, device=self.device
        )


def zoo_quadrotor(N: int = 50, tf: float = 2.5, *, dtype=torch.float32, device=None):
    """The zoo's quadrotor (n=13, m=4): hover at (0, 0, 1) to hover at
    (1.5, 1, 2), thrusts bounded to [0, 4] (`perf/benchmark_zoo.py:54-74`).
    Returns (compiled problem, initial trajectory at hover thrust, x0, xf)."""
    dev = default_device(device)
    n, m = 13, 4
    h = tf / N
    x0 = hover_state((0.0, 0.0, 1.0), dtype=dtype, device=dev)
    xf = hover_state((1.5, 1.0, 2.0), dtype=dtype, device=dev)
    uh = hover_controls(dtype=dtype, device=dev)
    kw = dict(dtype=dtype, device=dev)
    prob = Problem(N)
    prob.set_initial_state(x0)
    prob.set_dynamics(quadrotor_rk4(**kw), range(N))
    prob.set_cost(lqr_cost(torch.eye(n, **kw) * 1e-2 * h, torch.eye(m, **kw) * 1e-1 * h, xf, uh), range(N))
    prob.set_cost(lqr_cost(torch.eye(n, **kw) * 100.0, torch.zeros((m, m), **kw), xf, uh, terminal=True), N)
    prob.set_constraint(control_bound(torch.zeros(m, **kw), torch.full((m,), 4.0, **kw)), range(N))
    Z0 = initial_trajectory(n, m, N, h, u0=uh, dtype=dtype, device=dev)
    return prob.compile(), Z0, x0, xf


def zoo_cartpole(N: int = 60, tf: float = 2.0, *, dtype=torch.float32, device=None):
    """The zoo's cartpole swing-up (n=4, m=1): from rest to θ = π, force
    bounded to ±10 (`perf/benchmark_zoo.py:77-97`).  Returns (compiled
    problem, initial trajectory at u = 0.01, x0, xf)."""
    dev = default_device(device)
    n, m = 4, 1
    h = tf / N
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)  # noqa: E731
    x0 = t(np.zeros(n))
    xf = t([0.0, np.pi, 0.0, 0.0])
    prob = Problem(N)
    prob.set_initial_state(x0)
    prob.set_dynamics(cartpole_rk4(dtype=dtype, device=dev), range(N))
    prob.set_cost(lqr_cost(t(np.eye(n) * 1e-2 * h), t(np.eye(m) * 1e-1 * h), xf, t(np.zeros(m))), range(N))
    prob.set_cost(
        lqr_cost(t(np.eye(n) * 100.0), t(np.zeros((m, m))), xf, t(np.zeros(m)), terminal=True), N
    )
    prob.set_constraint(control_bound(t([-10.0]), t([10.0])), range(N))
    Z0 = initial_trajectory(n, m, N, h, u0=np.full(m, 0.01), dtype=dtype, device=dev)
    return prob.compile(), Z0, x0, xf


def randomized_fleet(defn: UnicycleProblem, prob, B: int, *, seed: int = 0):
    """The randomized three-obstacle fleet's per-lane params
    (`perf/benchmark_randomized.py:make_randomized_fleet`), drawn from
    numpy's `default_rng(seed)` in its order: per lane, the obstacle
    centres jittered by ±0.2 and the radii scaled by U(0.8, 1.1) [3, B]; the
    goal xf moved by U(0, 0.3) in x and y and by ±0.3 in θ [3, B], which
    enters the goal constraint and the tracking cost's q = −Q_k xf
    [N+1, 3, B] and c = ½ xfᵀQ_k xf [N+1, B] (the stage and terminal costs
    are one stacked family); x0 in ±0.1 [3, B].  `prob` is
    `defn.make_problem().compile()` of the three-obstacle scenario.  Returns
    (params, the obstacles (cx, cy, r) as float64 numpy arrays [3, B], xf
    likewise)."""
    if defn.obstacles is None:
        raise ValueError("randomized_fleet takes the three-obstacle scenario")
    rng = np.random.default_rng(seed)
    cx0, cy0, r0 = defn.obstacles
    cx = cx0[:, None] + rng.uniform(-0.2, 0.2, (3, B))
    cy = cy0[:, None] + rng.uniform(-0.2, 0.2, (3, B))
    rr = r0[:, None] * rng.uniform(0.8, 1.1, (3, B))
    xf = np.broadcast_to(defn.xf[:, None], (3, B)).copy()
    xf[0] += rng.uniform(0.0, 0.3, B)
    xf[1] += rng.uniform(0.0, 0.3, B)
    xf[2] += rng.uniform(-0.3, 0.3, B)
    x0 = rng.uniform(-0.1, 0.1, (3, B))
    params = prob.params
    kinds = [f.constraint.structure[0] for f in prob.constraint_families]
    cons = list(params.constraints)
    ci, gi = kinds.index("circle"), kinds.index("goal")
    cons[ci] = dict(cons[ci], cx=defn._t(cx), cy=defn._t(cy), r=defn._t(rr))
    xf_t = defn._t(xf)
    cons[gi] = dict(cons[gi], xf=xf_t)
    cp0 = params.costs[0]
    Q = cp0["Q"]  # [N+1, 3, 3]: the stage and terminal rows of one family
    q = -torch.einsum("kij,jb->kib", Q, xf_t)
    c = 0.5 * torch.einsum("ib,kij,jb->kb", xf_t, Q, xf_t)
    params = params.replace(x0=defn._t(x0), constraints=tuple(cons),
                            costs=(dict(cp0, q=q.contiguous(), c=c.contiguous()),))
    return params, (cx, cy, rr), xf


def soc_unicycle(N: int = 40, vmax: float = 0.8, *, dtype=torch.float64, device=None):
    """The turn-90 parking problem without its control bound and goal
    constraint, with a velocity cone |v| <= vmax at every stage, a
    second-order cone of dimension 2 (tests/test_batched_soc.py:54-75).
    Returns (problem definition, compiled problem)."""
    defn = UnicycleProblem(N=N, dtype=dtype, device=device)
    prob = defn.make_problem(add_constraints=False)

    def soc_fn(params, x, u):
        del x
        return torch.stack([u[0], params["vmax"]])

    soc = Constraint(params={"vmax": defn._t(vmax)}, fn=soc_fn, cone=Cone.SECOND_ORDER, dim=2,
                     label="Velocity SOC")
    prob.set_constraint(soc, range(N))
    return defn, prob.compile()


def _damped_fn(dof: int):
    def fn(params, x, u, t):
        del t
        return torch.cat([x[dof: 2 * dof], x[2 * dof: 3 * dof] - params["c"] * x[dof: 2 * dof], u], dim=0)

    return fn


def _integrator_problem(dof: int, N: int, dtype, device) -> tuple:
    """A problem of N segments on triple-integrator states of `dof`
    degrees of freedom, from every position at −1 to every position at 1 at
    rest: tracking costs I, 0.01 I and terminal 1e4 I, the goal held at
    knot N (tests/test_batched_heterogeneous.py:35-61 at dof=1).  Returns
    (problem without dynamics, x0, xf) with x0, xf as float64 numpy."""
    dev = default_device(device)
    n, m = 3 * dof, dof
    xf = np.zeros(n)
    xf[:dof] = 1.0
    x0 = np.zeros(n)
    x0[:dof] = -1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)  # noqa: E731
    prob = Problem(N)
    prob.set_cost(lqr_cost(t(np.eye(n)), t(np.eye(m) * 0.01), t(xf)), range(N))
    prob.set_cost(lqr_cost(t(np.eye(n) * 1e4), t(np.zeros((m, m))), t(xf), terminal=True), N)
    prob.set_constraint(goal_constraint(t(xf)), N)
    prob.set_initial_state(t(x0))
    return prob, x0, xf


def hybrid_triple_integrator(dof: int = 1, N: int = 20, *, damping: float = 0.5, dtype=torch.float64,
                             device=None) -> tuple:
    """Two dynamics families: the triple integrator on the first N/2
    segments, a damped variant (acceleration's rate reduced by c times the
    velocity, c = `damping`) on the rest.  Returns (compiled problem, x0,
    xf), x0 and xf as float64 numpy."""
    prob, x0, xf = _integrator_problem(dof, N, dtype, device)
    dev = default_device(device)
    damped = discretize(ContinuousModel(
        params={"c": torch.as_tensor(damping, dtype=dtype, device=dev)}, fn=_damped_fn(dof),
        n=3 * dof, m=dof, name=f"damped_triple_integrator{dof}",
    ), "rk4")
    prob.set_dynamics(triple_integrator_rk4(dof), range(N // 2))
    prob.set_dynamics(damped, range(N // 2, N))
    return prob.compile(), x0, xf


def damping_schedule(dof: int = 1, N: int = 16, *, dtype=torch.float64, device=None) -> tuple:
    """One dynamics family with per-knot params: the damped triple
    integrator with c = 0.2 + 0.05 k on segment k, stacked [N].  Returns
    (compiled problem, x0, xf), x0 and xf as float64 numpy."""
    prob, x0, xf = _integrator_problem(dof, N, dtype, device)
    dev = default_device(device)
    base = discretize(ContinuousModel(
        params={"c": torch.as_tensor(0.2, dtype=dtype, device=dev)}, fn=_damped_fn(dof),
        n=3 * dof, m=dof, name=f"damped_triple_integrator{dof}",
    ), "rk4")
    for k in range(N):
        prob.set_dynamics(dataclasses.replace(base, params={"c": torch.as_tensor(0.2 + 0.05 * k, dtype=dtype,
                                                                                    device=dev)}), k)
    return prob.compile(), x0, xf
