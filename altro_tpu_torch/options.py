"""Solver options: the fields and defaults of `altro_tpu.options`.

Two selections differ from the JAX package:
  * `forward_pass` takes "scan" or "cuda"; the JAX value "pallas" names the
    fused forward kernel there and maps to "cuda" here.
  * `backward_pass` takes "scan", "riccati" or "fused"; the JAX value
    "pallas" names the stand-alone Riccati kernel there and maps to
    "riccati" here, and "pscan" stays retired.
The TPU tile knob `kernel_sublanes` is not carried: a CUDA launch's block
size takes its place.
"""
from __future__ import annotations

import dataclasses
import enum


class LogLevel(enum.IntEnum):
    """Console verbosity levels (`altro/common/log_entry.hpp:27-34`)."""

    SILENT = 0
    OUTER = 1
    OUTER_DEBUG = 2
    INNER = 3
    INNER_DEBUG = 4
    DEBUG = 5


_BACKWARD = ("scan", "riccati", "fused")
_FORWARD = ("scan", "cuda")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    # Iteration caps (`solver_options.hpp:23-25`)
    max_iterations_total: int = 300
    max_iterations_outer: int = 30
    max_iterations_inner: int = 100

    # Convergence tolerances (`solver_options.hpp:26-27`)
    cost_tolerance: float = 1e-4
    gradient_tolerance: float = 1e-2

    # Backward-pass regularization schedule (`solver_options.hpp:29-35`);
    # bp_reg_enable is declared but never read, as in the reference
    bp_reg_increase_factor: float = 1.6
    bp_reg_enable: bool = True
    bp_reg_initial: float = 0.0
    bp_reg_max: float = 1e8
    bp_reg_min: float = 1e-8
    bp_reg_fail_threshold: int = 100

    # Forward-pass rollout guards (`solver_options.hpp:36-38`)
    check_forwardpass_bounds: bool = True
    state_max: float = 1e8
    control_max: float = 1e8

    # Line search (`solver_options.hpp:40-43`)
    line_search_max_iterations: int = 20
    line_search_lower_bound: float = 1e-8
    line_search_upper_bound: float = 10.0
    line_search_decrease_factor: float = 2.0

    # Augmented Lagrangian (`solver_options.hpp:45-48`)
    constraint_tolerance: float = 1e-4
    maximum_penalty: float = 1e8
    initial_penalty: float = 1.0
    penalty_scaling: float = 10.0
    reset_duals: bool = True

    # Logging / profiling (`solver_options.hpp:49-54`)
    header_frequency: int = 10
    verbose: LogLevel = LogLevel.SILENT
    profiler_enable: bool = False
    profiler_output_to_file: bool = False
    log_directory: str = ""
    profile_filename: str = "profiler.out"

    # Consecutive iterations with dJ < cost_tolerance before an inner solve
    # exits as SOLVED_STALLED; 0 disables (see `altro_tpu.options`)
    max_stall_iterations: int = 10

    # Whether a feasible stall-exited instance ends the outer loop as
    # SOLVED_STALLED (True) or keeps escalating the penalty (False)
    stalled_feasible_exits: bool = True

    # Gains above this bound count as a backward-pass failure
    bp_gain_limit: float = 1e8

    # "highest" keeps float32 matrix products in full float32: on CUDA
    # that means TF32 off, which `solver/batched.py` sets at import
    matmul_precision: str = "highest"

    # Unroll factor of the JAX package's time scans; the port's loops are
    # Python loops or kernels, so it is accepted and has no effect
    scan_unroll: int = 1

    # "scan" (eager Riccati recursion, the parity oracle), "riccati" (the
    # Riccati sweep as a CUDA kernel over the eager expansions,
    # `ops/riccati.py`; "pallas" is accepted as the JAX name for it) or
    # "fused" (expansions and Riccati sweep in one CUDA kernel,
    # `ops/backward_fused.py`, with "riccati" as its fallback)
    backward_pass: str = "scan"

    # "scan" (eager rollout + cost) or "cuda" (fused rollout + cost kernel,
    # `ops/forward.py`); "pallas" is accepted as the JAX name for "cuda"
    forward_pass: str = "scan"

    # Evaluate the outer-loop constraint values, dual update and violation
    # measure in float64 (see `altro_tpu.options`)
    outer_constraints_f64: bool = False

    # Speculative line-search width: step sizes tried in one forward-kernel
    # launch (1: the sequential search)
    line_search_parallel: int = 1

    # Rows of the per-instance solver's iteration history (`SolverStats`)
    stats_capacity: int = 304

    # Per-iteration history rows of the batched solver (`BatchedStats.rows`);
    # 0 records nothing
    iteration_history_capacity: int = 0

    # Whether the outer loop updates duals after an unconverged inner solve
    update_duals_on_failed_inner: bool = True

    def __post_init__(self):
        if self.forward_pass == "pallas":
            object.__setattr__(self, "forward_pass", "cuda")
        if self.backward_pass == "pallas":
            object.__setattr__(self, "backward_pass", "riccati")
        if self.backward_pass == "pscan":
            raise ValueError(
                "backward_pass='pscan' was retired (measured slower than "
                "the sequential sweep everywhere); use 'scan', 'riccati' or 'fused', "
                "or call solver.pscan.backward_pass_pscan or "
                "solver.pscan_batched.riccati_pscan_batched directly for research"
            )
        if self.backward_pass not in _BACKWARD:
            raise ValueError(
                f"backward_pass={self.backward_pass!r}; expected one of "
                f"{_BACKWARD} (or 'pallas', the JAX name for 'riccati')"
            )
        if self.forward_pass not in _FORWARD:
            raise ValueError(
                f"forward_pass={self.forward_pass!r}; expected one of "
                f"{_FORWARD} (or 'pallas', the JAX name for 'cuda')"
            )

    def replace(self, **updates) -> "SolverOptions":
        return dataclasses.replace(self, **updates)
