"""altro_tpu_torch — AL-iLQR trajectory optimization on PyTorch and CUDA.

The PyTorch counterpart of `altro_tpu` (JAX), module for module: the same
problem layer, the per-instance AL-iLQR solver and its receding-horizon
controllers, the same batch-last lockstep solver, and the fused backward
and forward passes as CUDA C++ kernels written for Hopper (`csrc/`).  It
imports torch and never jax; `altro_tpu` stays the reference that the tests
hold this package against.
"""

from .options import LogLevel, SolverOptions
from .types import SolverStats, SolverStatus, Trajectory, initial_trajectory
from .problem.costs import Cost, lqr_cost, quadratic_cost
from .problem.constraints import (
    Cone,
    Constraint,
    EQUALITY,
    INEQUALITY,
    circle_constraint,
    control_bound,
    goal_constraint,
)
from .problem.dynamics import (
    ContinuousModel,
    DiscreteModel,
    discretize,
    euler_step,
    rk4_step,
)
from .problem.problem import CompiledProblem, Problem, ProblemParams
from .solver.ilqr import ILQRSolver
from .solver.al import ALSolver
from .solver.mpc import MPC, BatchedMPC

__version__ = "0.1.0"

__all__ = [
    "ALSolver",
    "BatchedMPC",
    "CompiledProblem",
    "Cone",
    "Constraint",
    "ContinuousModel",
    "Cost",
    "DiscreteModel",
    "EQUALITY",
    "ILQRSolver",
    "INEQUALITY",
    "LogLevel",
    "MPC",
    "Problem",
    "ProblemParams",
    "SolverOptions",
    "SolverStats",
    "SolverStatus",
    "Trajectory",
    "circle_constraint",
    "control_bound",
    "discretize",
    "euler_step",
    "goal_constraint",
    "initial_trajectory",
    "lqr_cost",
    "quadratic_cost",
    "rk4_step",
]
