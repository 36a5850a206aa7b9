"""The systems under test, behind the two interfaces the traffic drivers
use.  States and controls cross them with the lanes first: x [B, n],
X [B, N+1, n], U [B, N, m], u [B, m].

`ProgramFleet` and `ProgramMPC` are the port (`altro_tpu_torch`), built
as the configuration says.  `ReferenceFleet` and `ReferenceMPC` put the
plain reference in the program's place, in the control's arithmetic; they
serve the check of the comparison (`benchmark/calibrate.py`).

A fleet system has `solve(x0) -> dict(X, U, solved)`, the counters of its
last solve (`counters()`) and the widths of its kernel launches
(`launch_counts()`).  A controller has `init(B)`, `step(state, x) -> (u,
state, status)` and `lanes(state, idx)`, which copies the indexed lanes'
warm start and AL state out in the reference's layout.
"""
from __future__ import annotations

import torch

from . import spec
from ..reference import altro, constraints as kinds, problem as ref_problem
from ..reference.arith import Arith

# options of the program that choose its code paths and have no meaning
# for the reference's arithmetic
PROGRAM_ONLY = ("backward_pass", "forward_pass", "scan_unroll", "outer_constraints_f64")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _replicate(Z0, B):
    from altro_tpu_torch.solver.batched import BatchedTrajectory

    return BatchedTrajectory(X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
                             U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h)


def _program(cfg, device):
    build = spec.load_module("program", cfg["program"]).build
    return build(cfg, device, DTYPES[cfg["dtype"]])


class ProgramFleet:
    def __init__(self, cfg: dict, lanes: int, device):
        from altro_tpu_torch import SolverOptions, SolverStatus
        from altro_tpu_torch.solver.batched import ALSolverBatched
        from altro_tpu_torch.solver.compaction import CompactedALSolver

        self._solved = int(SolverStatus.SOLVED)
        prob, Z0 = _program(cfg, device)
        sv = cfg["solver"]
        opts = SolverOptions(**sv["options"])
        self.driver = sv["driver"]
        if self.driver == "compacted":
            self.solver = CompactedALSolver(
                prob, opts, phase1_iters=sv["phase1_iters"], tail_batch=min(sv["tail_batch"], lanes),
                f64_polish=sv["f64_polish"], device_tail=sv["device_tail"])
            self._kernels = dict(
                backward_fused=[(self.solver._p1, "_bwd", lanes), (self.solver._tail, "_bwd", self.solver.tail_batch)],
                forward=[(self.solver._p1, "_fwd", lanes), (self.solver._tail, "_fwd", self.solver.tail_batch)])
        elif self.driver == "batched":
            self.solver = ALSolverBatched(prob, opts)
            self._kernels = dict(backward_fused=[(self.solver, "_bwd", lanes)], forward=[(self.solver, "_fwd", lanes)])
        else:
            raise ValueError(f"unknown solver driver {self.driver!r}")
        self.params = prob.params
        self.Zb = _replicate(Z0, lanes)

    def solve(self, x0):
        res = self.solver.solve(self.params.replace(x0=x0.T.contiguous()), self.Zb)
        Z = res["Z"]
        return dict(X=Z.X.permute(2, 0, 1), U=Z.U.permute(2, 0, 1), solved=res["status"] == self._solved)

    def counters(self) -> dict:
        out = dict(host_syncs=self.solver.host_syncs)
        if self.driver == "compacted":
            out["tail_rounds"] = self.solver.telemetry.get("tail_rounds")
        return out

    def launch_counts(self) -> dict:
        """{kernel: [(lanes per launch, launches so far), ...]} of the
        float32 kernels."""
        return {k: [(w, getattr(obj, attr).launches) for obj, attr, w in v] for k, v in self._kernels.items()}


class ProgramMPC:
    def __init__(self, cfg: dict, lanes: int, device):
        from altro_tpu_torch import BatchedMPC, SolverOptions, SolverStatus

        prob, Z0 = _program(cfg, device)
        self._solved = int(SolverStatus.SOLVED)
        self.mpc = BatchedMPC(prob, SolverOptions(**cfg["mpc"]["options"]), shift=bool(cfg["mpc"]["shift"]))
        self.Zb = _replicate(Z0, lanes)
        # the constraint families in the reference's names, as the
        # configuration maps them
        self._fams = [cfg["program_constraints"][f.label] for f in prob.constraint_families]

    def init(self, B: int):
        return self.mpc.init(self.Zb)

    def step(self, state, x):
        u, state = self.mpc.step(state, x.T.contiguous())
        return u.T, state, state.status == self._solved

    def lanes(self, state, idx) -> dict:
        al = {}
        for kind, st in zip(self._fams, state.al):
            lam = st["lam"][..., idx].permute(2, 0, 1)  # [S, nk, p]
            rho = st["rho"][..., idx].permute(1, 0)  # [S, nk]
            al[kind] = (lam, rho) if kinds.kind(kind).KNOTS == "stage" else (lam[:, 0], rho[:, 0])
        return dict(U=state.Z.U[..., idx].permute(2, 0, 1).clone(), al=al)

    def counters(self) -> dict:
        s = self.mpc.solver
        return dict(host_syncs=self.mpc.host_syncs, fwd_launches=s._fwd.launches if s._fwd is not None else 0)

    def launch_counts(self) -> dict:
        s = self.mpc.solver
        B = self.Zb.X.shape[-1]
        return dict(backward_fused=[(B, s._bwd.launches)], forward=[(B, s._fwd.launches)])


def reference_options(options: dict) -> dict:
    return altro.options(**{k: v for k, v in options.items() if k not in PROGRAM_ONLY})


class ReferenceFleet:
    """The reference in the control's arithmetic, solving the whole fleet
    in one lockstep batch with the program's options (and `over`, the
    cell's `control_options`)."""

    def __init__(self, cfg: dict, lanes: int, device, ar: Arith, over: dict | None = None):
        prob = ref_problem.build(cfg["problem"], ar.dtype, device)
        self.solver = altro.Solver(prob, reference_options({**cfg["solver"]["options"], **(over or {})}), ar, device)
        self.U0 = prob.initial_controls(lanes)

    def solve(self, x0):
        r = self.solver.solve(x0, self.U0)
        return dict(X=r["X"], U=r["U"], solved=r["status"] == altro.SOLVED)

    def counters(self) -> dict:
        return {}

    def launch_counts(self) -> dict:
        return {}


class ReferenceMPC:
    def __init__(self, cfg: dict, lanes: int, device, ar: Arith, over: dict | None = None):
        prob = ref_problem.build(cfg["problem"], ar.dtype, device)
        self.mpc = altro.MPC(prob, reference_options({**cfg["mpc"]["options"], **(over or {})}), ar, device)

    def init(self, B: int):
        return self.mpc.init(B)

    def step(self, state, x):
        u, state, status = self.mpc.step(state, x)
        return u, state, status == altro.SOLVED

    def lanes(self, state, idx) -> dict:
        return dict(U=state["U"][idx].clone(), al={k: (l[idx].clone(), r[idx].clone()) for k, (l, r) in state["al"].items()})

    def counters(self) -> dict:
        return {}

    def launch_counts(self) -> dict:
        return {}
