"""Batch-native AL-iLQR on PyTorch: thousands of solves in lockstep, batch last.

The counterpart of `altro_tpu/solver/batched.py`.  Every state is
`[..., n, B]`; the tiny per-knot algebra is broadcast-multiply-reduce over
the small axes, elementwise over the batch, and the m×m Cholesky is
unrolled over static indices.  Each batch element follows the iteration
path it would take alone: per-instance regularization, line-search α, dual
and penalty state, and convergence masks that freeze finished instances.

Each lockstep `lax.while_loop` of the JAX package is a Python `while` over
device masks here, so every exit test is one host synchronisation, read
through `utils/timer.py:host_read` at its site (`inner_exit`, `outer_exit`,
`line_search`, `bp_retry`; the live fleet rows of `verbose` > SILENT,
`fleet_row`); `ALSolverBatched.host_syncs` counts them per solve, the
kernels' (`kernel_prep`) included.  The line search is the exception where
the forward kernel runs: the kernel searches each lane on the device, in
one launch with no exit test (`line_search` syncs remain on the eager path
and with `line_search_parallel` S > 1).  The loops' phases are tracer spans:
`al.solve`, `al.outer`, `al.duals`, `ilqr.rollout`, `ilqr.iter`,
`ilqr.backward`, `ilqr.forward`.

The eager passes (`expand` + `riccati_scan`, `closed_loop_rollout` +
`total_cost`) are the parity oracle and the plain versions of the CUDA
kernels: `backward_pass="fused"` selects the fused backward kernel
(`ops/backward_fused.py`), `backward_pass="riccati"` (the JAX name
"pallas") the stand-alone Riccati sweep over the eager expansions
(`ops/riccati.py`), which is also the fused path's fallback for problems
the fused kernel does not take, and `forward_pass="cuda"` the forward
kernel (`ops/forward.py`).

Layout convention: batch axis LAST.
  X [N+1, n, B]   U [N, m, B]   K [N, m, n, B]   d [N, m, B]
  lam [nk, p, B]  rho [nk, B]   scalars [B]
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops.backward_fused import comp_circle
from ..options import LogLevel, SolverOptions
from ..problem.constraints import Cone, dual_cone
from ..problem.costs import _quadcost_eval, ad_expansion
from ..problem.problem import CompiledProblem, ProblemParams, param_row
from ..types import SolverStatus, Trajectory
from ..utils.timer import host_read, host_reads, root_span, search_counts, span
from ..utils.timer import ls_block_tries as _ls_block_tries
from ..utils.timer import ls_tries as _ls_tries

# SolverOptions.matmul_precision="highest": float32 matrix products stay in
# full float32 on CUDA, so TF32 is off for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# ----------------------------------------------------------------- helpers


def mm(a, b):
    """[..., i, j, B] @ [..., j, k, B] -> [..., i, k, B]."""
    return (a[..., :, :, None, :] * b[..., None, :, :, :]).sum(dim=-3)


def mv(a, v):
    """[..., i, j, B] @ [..., j, B] -> [..., i, B]."""
    return (a * v[..., None, :, :]).sum(dim=-2)


def mT(a):
    return a.transpose(-3, -2)


def dotv(a, b):
    """[..., i, B] · [..., i, B] -> [..., B]."""
    return (a * b).sum(dim=-2)


def chol_unrolled(M):
    """Cholesky of [..., m, m, B] unrolled over static indices.

    Returns the lower-triangular entries [i][j] as [..., B] tensors, NaN
    where the matrix is not PD (the batched analog of an Eigen LLT failure,
    `knot_point_function_type.hpp:197-211`).
    """
    m = M.shape[-3]
    cols = [[None] * m for _ in range(m)]
    for j in range(m):
        s = M[..., j, j, :]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        dj = torch.sqrt(s)
        cols[j][j] = dj
        inv_dj = 1.0 / dj
        for i in range(j + 1, m):
            s = M[..., i, j, :]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv_dj
    return cols


def chol_solve_mat(L, R):
    """Solve (L Lᵀ) X = R with R [..., m, r, B], L from chol_unrolled."""
    m = len(L)
    y = [None] * m
    for i in range(m):
        acc = R[..., i, :, :]
        for k in range(i):
            acc = acc - L[i][k][..., None, :] * y[k]
        y[i] = acc / L[i][i][..., None, :]
    x = [None] * m
    for i in reversed(range(m)):
        acc = y[i]
        for k in range(i + 1, m):
            acc = acc - L[k][i][..., None, :] * x[k]
        x[i] = acc / L[i][i][..., None, :]
    return torch.stack(x, dim=-3)


def chol_solve_vec(L, v):
    """Solve (L Lᵀ) x = v with v [..., m, B]."""
    return chol_solve_mat(L, v[..., :, None, :])[..., :, 0, :]


def chol_failed(L):
    """Per-instance failure mask [..., B]: any non-finite factor entry."""
    bad = None
    for i, row in enumerate(L):
        for j in range(i + 1):
            b = ~torch.isfinite(row[j])
            bad = b if bad is None else bad | b
    return bad


def soc_project_bl(s):
    """Lorentz-cone projection, batch-last: s [nk, p, B] with the cone
    scalar in row p-1 (`problem/constraints.py:_soc_project` is the
    per-instance form)."""
    v = s[:, :-1, :]
    t = s[:, -1, :]
    a = torch.sqrt((v * v).sum(dim=1))  # [nk, B]
    inside = a <= t
    polar = a <= -t
    scale = 0.5 * (1.0 + t / torch.clamp(a, min=torch.finfo(s.dtype).tiny))
    proj = torch.cat([scale[:, None, :] * v, (0.5 * (a + t))[:, None, :]], dim=1)
    return torch.where(inside[:, None, :], s, torch.where(polar[:, None, :], 0.0, proj))


def soc_jacobian_bl(s):
    """Projection Jacobian of the Lorentz cone, batch-last: [nk, p, p, B]
    (`problem/constraints.py:cone_jacobian` is the per-instance form)."""
    nk, p, Bsz = s.shape
    dt = s.dtype
    v = s[:, :-1, :]
    t = s[:, -1, :]
    a = torch.sqrt((v * v).sum(dim=1))
    a_s = torch.clamp(a, min=torch.finfo(dt).tiny)
    inside = a <= t
    polar = a <= -t
    c = 0.5 + t / (2.0 * a_s)
    vv = v[:, :, None, :] * v[:, None, :, :]  # [nk, p-1, p-1, B]
    eye_v = torch.eye(p - 1, dtype=dt, device=s.device)[None, :, :, None]
    dPv_dv = c[:, None, None, :] * eye_v - (t / (2.0 * a_s**3))[:, None, None, :] * vv
    dPv_dt = v / (2.0 * a_s[:, None, :])  # [nk, p-1, B]
    top = torch.cat([dPv_dv, dPv_dt[:, :, None, :]], dim=2)
    half = s.new_full((nk, 1, 1, Bsz), 0.5)
    bot = torch.cat([dPv_dt[:, None, :, :], half], dim=2)
    J = torch.cat([top, bot], dim=1)  # [nk, p, p, B]
    eye_p = torch.eye(p, dtype=dt, device=s.device)[None, :, :, None]
    return torch.where(inside[:, None, None, :], eye_p,
                       torch.where(polar[:, None, None, :], 0.0, J))


def _tree_map2(fn: Callable, canon, tree):
    """Map `fn(canonical_leaf, leaf)` over two param trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, canon[k], v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map2(fn, c, v) for c, v in zip(canon, tree))
    return fn(canon, tree)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def per_instance(canon, leaf) -> bool:
    """A param leaf is per-instance when it carries a trailing batch axis:
    its rank exceeds the canonical (unbatched) leaf's by one."""
    return torch.as_tensor(leaf).ndim == torch.as_tensor(canon).ndim + 1


def batch_axes(canon, actual):
    """Per-leaf vmap axis spec for possibly per-instance problem params
    (`altro_tpu/solver/batched.py:batch_axes`): -1 for the leaves with a
    trailing batch axis (goal `q` [n] -> [n, B], obstacle centres [n_obs]
    -> [n_obs, B], masses () -> [B]), None for shared ones; usable as a
    `torch.func.vmap` in_dims tree."""
    return _tree_map2(lambda c, a: -1 if per_instance(c, a) else None, canon, actual)


def any_batched(canon, actual) -> bool:
    """True if any leaf of `actual` carries a trailing batch axis."""
    return any(per_instance(c, a) for c, a in zip(_leaves(canon), _leaves(actual)))


def gather_params(canon: ProblemParams, params: ProblemParams, idx) -> ProblemParams:
    """`params` with every per-instance leaf (x0 included) gathered to the
    lanes `idx`; shared leaves stay as they are
    (`altro_tpu/solver/compaction.py:222-232`).  `canon`: the compiled
    problem's own params."""
    take = lambda c, leaf: leaf[..., idx] if per_instance(c, leaf) else leaf  # noqa: E731
    return ProblemParams(*(_tree_map2(take, getattr(canon, f.name), getattr(params, f.name))
                           for f in dataclasses.fields(params)))


def al_select(mask, a, b):
    """Masked select over two AL-state tuples of {lam, rho} dicts."""
    return tuple(
        dict(lam=torch.where(mask, sa["lam"], sb["lam"]),
             rho=torch.where(mask, sa["rho"], sb["rho"]))
        for sa, sb in zip(a, b)
    )


# ----------------------------------------------------------------- state


@dataclasses.dataclass(frozen=True)
class BatchedStats:
    """Per-instance counters and convergence scalars, shapes [B]
    (`altro_tpu.solver.batched.BatchedStats`).

    `rows` is the per-iteration history, the batched analog of the
    reference's per-iteration stats vectors (`solver_stats.hpp:54-61`):
    `[capacity, 8, B]` in `_HISTORY_COLUMNS` order, row i holding instance
    b's values after its (i+1)-th total iteration.  Capacity 0 (the
    default) records nothing.
    """

    iterations_inner: torch.Tensor
    iterations_outer: torch.Tensor
    iterations_total: torch.Tensor
    initial_cost: torch.Tensor
    cost: torch.Tensor
    cost_decrease: torch.Tensor
    gradient: torch.Tensor
    alpha: torch.Tensor
    improvement_ratio: torch.Tensor
    violations: torch.Tensor
    max_penalty: torch.Tensor
    regularization: torch.Tensor
    rows: torch.Tensor  # [capacity, 8, B]

    def replace(self, **updates) -> "BatchedStats":
        return dataclasses.replace(self, **updates)


_HISTORY_COLUMNS = (
    "cost",
    "alpha",
    "improvement_ratio",
    "gradient",
    "cost_decrease",
    "regularization",
    "violations",
    "max_penalty",
)


def batched_stats_init(B: int, dtype, history_capacity: int = 0, device=None) -> BatchedStats:
    """Zeroed stats of B lanes with `history_capacity` history rows, on
    `device` (None: the default device)."""
    z = torch.zeros((B,), dtype=dtype, device=device)
    i = torch.zeros((B,), dtype=torch.int32, device=device)
    return BatchedStats(
        iterations_inner=i, iterations_outer=i, iterations_total=i,
        initial_cost=z, cost=z, cost_decrease=z, gradient=z, alpha=z,
        improvement_ratio=z, violations=z, max_penalty=z, regularization=z,
        rows=torch.zeros((history_capacity, len(_HISTORY_COLUMNS), B), dtype=dtype, device=device),
    )


def batched_stats_column(stats: BatchedStats, name: str) -> torch.Tensor:
    """History column `name` as [capacity, B]; instance b's rows are valid up
    to `stats.iterations_total[b]` (`altro_tpu.types.stats_column` analog)."""
    return stats.rows[:, _HISTORY_COLUMNS.index(name), :]


def _record_history(stats: BatchedStats, active) -> BatchedStats:
    """Write the current column values into each active instance's row
    `iterations_total - 1`, clipped to the last row (call after the
    per-iteration stats update).

    A scatter of one row per lane, in place: it moves 2·8·B values where
    the JAX package's one-hot masked select (chosen there for the TPU's
    layouts) reads and writes the whole [capacity, 8, B] buffer.  Inactive
    lanes write back the value they hold.  `rows` is the solve's own buffer
    (`batched_stats_init`), so no other result shares it."""
    cap = stats.rows.shape[0]
    if cap == 0:
        return stats
    vals = torch.stack([getattr(stats, name) for name in _HISTORY_COLUMNS], dim=1)  # [B, 8]
    row = torch.clamp(stats.iterations_total.long() - 1, 0, cap - 1)  # [B]
    lane = torch.arange(row.shape[0], device=row.device)
    rows = stats.rows
    rows[row, :, lane] = torch.where(active[:, None], vals, rows[row, :, lane])
    return stats


@dataclasses.dataclass(frozen=True)
class BatchedTrajectory:
    """Batch-last trajectory: X [N+1, n, B], U [N, m, B]; shared t, h."""

    X: torch.Tensor
    U: torch.Tensor
    t: torch.Tensor  # [N+1]
    h: torch.Tensor  # [N]

    def replace(self, **updates) -> "BatchedTrajectory":
        return dataclasses.replace(self, **updates)


def to_batch_last(Z) -> BatchedTrajectory:
    """Convert a batch-leading Trajectory (leaves [B, ...]) to batch-last."""
    return BatchedTrajectory(
        X=torch.movedim(Z.X, 0, -1).contiguous(),
        U=torch.movedim(Z.U, 0, -1).contiguous(),
        t=Z.t[0] if Z.t.ndim == 2 else Z.t,
        h=Z.h[0] if Z.h.ndim == 2 else Z.h,
    )


def from_batch_last(Zb: BatchedTrajectory) -> Trajectory:
    """The batch-leading `Trajectory` of a batch-last one, the inverse of
    `to_batch_last`: X [B, N+1, n], U [B, N, m], and the shared time grid
    broadcast to t [B, N+1], h [B, N]."""
    B = Zb.X.shape[-1]
    return Trajectory(
        X=torch.movedim(Zb.X, -1, 0).contiguous(),
        U=torch.movedim(Zb.U, -1, 0).contiguous(),
        t=Zb.t.expand((B,) + tuple(Zb.t.shape)),
        h=Zb.h.expand((B,) + tuple(Zb.h.shape)),
    )


def zselect(mask, Za: BatchedTrajectory, Zb: BatchedTrajectory) -> BatchedTrajectory:
    """Masked select on BatchedTrajectory (t, h carry no batch axis)."""
    return Za.replace(X=torch.where(mask, Za.X, Zb.X), U=torch.where(mask, Za.U, Zb.U))


# ----------------------------------------------------------------- solver


class ALSolverBatched:
    """Throughput-oriented batched AL-iLQR.

    Any problem datum may vary per instance: `x0` as [n, B], and any cost,
    constraint or dynamics param leaf by carrying a trailing batch axis
    beside its canonical shape (goal refs [n] -> [n, B], obstacle layouts
    [n_obs] -> [n_obs, B], masses () -> [B]; `batch_axes`).  Every cone
    is handled, the second-order cone with its dense projection Jacobian
    (`soc_project_bl`, `soc_jacobian_bl`).  Heterogeneous dynamics (several
    families, or one family with per-knot params, the reference's model per
    knot, `problem.hpp:159-183`) run the eager passes: the rollouts look up
    each segment's family on the host (`CompiledProblem.dyn_fam_id`), and
    the Jacobians are taken over each family's knots.
    `backward_pass="fused"` and `forward_pass="cuda"` run the CUDA kernels
    when the problem's structure is one they take (decided once, here) and
    the per-instance leaves of the params of a solve are laid out so that
    the TPU kernels take them too (`FusedKernel.takes`, decided per solve);
    other problems run the eager passes.  The backward pass
    of a problem the fused kernel refuses, and of `backward_pass="riccati"`,
    runs the Riccati kernel over the eager expansions when its (n, m) and
    scalar type have an instantiation, else the eager `riccati_scan`.  The
    JAX package runs `riccati_scan` whenever B % 1024 != 0; the port's
    kernel takes any B, which changes which code runs, not what is computed.

    `line_search_parallel` S > 1 evaluates S step sizes of the line search
    in one forward-kernel launch at S·B lanes (`_line_search_speculative`)
    where the forward kernel runs; it accepts what the sequential search
    accepts.  `verbose` > SILENT prints a fleet row per outer iteration
    (and per inner one at INNER), each one host synchronisation.

    `compensated_circles=True` evaluates circle constraint rows in
    compensated arithmetic (`ops/backward_fused.py:comp_circle`), as the
    fused kernels (and the TPU kernels) do: the solvers whose passes are
    the kernels' plain versions set it.  Otherwise every constraint runs its
    own `fn`, as the JAX package's scan path does.

    Two facts of the inner loop that `parallel/batch.py:_InstanceStats`
    builds on, and that a change here must keep or carry over to it: each
    inner iteration calls `forward_pass` once, and then, after
    `_record_history`, `_emit_inner_row(active, stats)` wherever
    `self._logger` is not None (the logger is only compared with None
    before it reaches `_emit_inner_row` and `_emit_outer_row`).
    """

    def __init__(self, prob: CompiledProblem, opts: SolverOptions = None, *,
                 compensated_circles: bool = False):
        self.prob = prob
        self.compensated_circles = bool(compensated_circles)
        self.opts = opts or SolverOptions()
        o = self.opts
        if o.line_search_parallel < 1:
            raise ValueError("line_search_parallel must be at least 1")
        # live fleet rows (`solver_logger.cpp:47-54`); SILENT builds none
        self._logger = None
        if o.verbose != LogLevel.SILENT:
            from ..utils.logging import SolverLogger

            self._logger = SolverLogger(o.verbose, frequency=o.header_frequency, fleet=True)
        x0 = prob.params.x0
        self.dtype = x0.dtype
        self.device = x0.device
        self._fwd = None
        if o.forward_pass == "cuda":
            from ..ops.forward import ForwardKernel, Ineligible

            try:
                self._fwd = ForwardKernel(prob, o, dtype=self.dtype, device=self.device)
            except Ineligible:
                self._fwd = None
        self._bwd = None
        if o.backward_pass == "fused":
            from ..ops.backward_fused import BackwardFusedKernel, Ineligible

            try:
                self._bwd = BackwardFusedKernel(
                    prob, o, dtype=self.dtype, device=self.device
                )
            except Ineligible:
                self._bwd = None
        self._ric = None
        if o.backward_pass == "riccati" or (o.backward_pass == "fused" and self._bwd is None):
            from ..ops.riccati import Ineligible, RiccatiKernel

            try:
                self._ric = RiccatiKernel(
                    prob.n, prob.m, gain_limit=o.bp_gain_limit, dtype=self.dtype
                )
            except Ineligible:
                self._ric = None
        self._knot_idx: dict[int, torch.Tensor] = {}
        # each dynamics family's knots: a slice where they are contiguous
        # (a single family's are every segment), else a device index
        self._dyn_knots = [_knot_slice(fam.knots) or self._knots(fam)
                           for fam in prob.dynamics_families]
        # each cost and constraint family's canonical (unbatched) params,
        # which tell its per-instance leaves apart (`batch_axes`)
        self._canon = {
            id(fam): cp
            for fams, cps in ((prob.cost_families, prob.params.costs),
                              (prob.constraint_families, prob.params.constraints))
            for fam, cp in zip(fams, cps)
        }
        # host synchronisations of the last `solve` (`host_read`s: one per
        # loop exit test, live row and read of the kernels' preparation)
        self.host_syncs = 0
        # the last solve's growth of `utils/timer.py:search_counts` (None
        # without the forward kernel)
        self.ls_counts = None
        # the speculative search's params and AL state widened to S·B lanes:
        # (params, S, widened params), (padded AL, S, widened padded AL)
        self._spec_params = None
        self._spec_al = None

    @staticmethod
    def _any(mask: torch.Tensor, site: str) -> bool:
        """One exit test: whether any lane of `mask` is set (one host read
        at `site`)."""
        return host_read(site, lambda: bool(mask.any()))

    # ------------------------------------------------------ live observability
    def _read_row(self, *vals) -> list:
        """One host read of a row's device values (one sync)."""
        row = torch.stack([v.to(torch.float64) for v in vals])
        return host_read("fleet_row", row.tolist)

    def _emit_inner_row(self, active, stats: BatchedStats) -> None:
        """The fleet's row after a lockstep inner iteration, at INNER and
        above (`altro_tpu/solver/batched.py:_emit_inner_row`): the most
        total iterations, the active lanes, and the medians of cost, cost
        decrease, α and gradient."""
        lg = self._logger
        if not lg.active("cost_med"):
            return
        iters, act, cost, dJ, alpha, grad = self._read_row(
            stats.iterations_total.max(), active.sum(), _median(stats.cost),
            _median(stats.cost_decrease), _median(stats.alpha), _median(stats.gradient),
        )
        for key, v in (("iters", int(iters)), ("active", int(act)), ("cost_med", cost),
                       ("dJ_med", dJ), ("alpha_med", alpha), ("grad_med", grad)):
            lg.log(key, v)
        lg.print_row()

    def _emit_outer_row(self, active, status, stats: BatchedStats) -> None:
        """The fleet's row after a lockstep outer iteration, at OUTER and
        above (`altro_tpu/solver/batched.py:_emit_outer_row`): the most
        outer and total iterations, the lanes going on, the SOLVED lanes,
        the largest violation and penalty, the median gradient."""
        lg = self._logger
        it_al, iters, act, solved, viol, pen, grad = self._read_row(
            stats.iterations_outer.max(), stats.iterations_total.max(), active.sum(),
            (status == int(SolverStatus.SOLVED)).sum(), stats.violations.max(),
            stats.max_penalty.max(), _median(stats.gradient),
        )
        for key, v in (("iter_al", int(it_al)), ("iters", int(iters)), ("active", int(act)),
                       ("solved", int(solved)), ("viol_max", viol), ("pen_max", pen),
                       ("grad_med", grad)):
            lg.log(key, v)
        lg.print_row()

    # -------------------------------------------------------- model kernels
    def _x0(self, params: ProblemParams, Bsz: int, dtype) -> torch.Tensor:
        x0 = params.x0
        if x0.ndim == 1:
            x0 = x0[:, None].expand(self.prob.n, Bsz)
        return x0.to(dtype)

    def _knots(self, fam) -> torch.Tensor:
        """A family's knot indices as a device tensor (cached)."""
        ks = self._knot_idx.get(id(fam))
        if ks is None:
            ks = torch.as_tensor(fam.knots, dtype=torch.long, device=self.device)
            self._knot_idx[id(fam)] = ks
        return ks

    def dyn_step_fam(self, fam, canon, fp, x, u, t, h):
        """One discrete step of family `fam` (params `fp`, one knot's),
        batch-last: the model takes x [n, B] as it takes x [n] (see
        problem/dynamics), and a per-instance param leaf's trailing batch
        axis broadcasts as x's does.  `canon`, the family's canonical
        params, is the JAX signature's: there it tells the per-instance
        leaves apart for `vmap`; broadcasting needs no such map, so it is
        not read here."""
        model = fam.model
        if model is not None and model.method == "rk4":
            f = model.continuous_fn
            k1 = f(fp, x, u, t)
            k2 = f(fp, x + 0.5 * h * k1, u, t + 0.5 * h)
            k3 = f(fp, x + 0.5 * h * k2, u, t + 0.5 * h)
            k4 = f(fp, x + h * k3, u, t + h)
            return x + h * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        if model is not None and model.method == "euler":
            return x + h * model.continuous_fn(fp, x, u, t)
        return fam.fn(fp, x, u, t, h)

    def _step_k(self, params: ProblemParams, k: int, x, u, t, h):
        """Segment k's step (`_dyn_step_k` / `_step_dispatch` of the JAX
        package): the family and params `CompiledProblem.dynamics_segment`
        names for k."""
        fam, fp = self.prob.dynamics_segment(params.dynamics, k)
        return self.dyn_step_fam(fam, None, fp, x, u, t, h)

    def dyn_step(self, params, x, u, t, h):
        """One step of the problem's first dynamics family (the JAX
        package's single-family fast path): `params` is that family's
        params."""
        return self.dyn_step_fam(self.prob.dynamics_families[0], self.prob.params.dynamics[0],
                                 params, x, u, t, h)

    def _fam_jacobian(self, fam, canon, fp, X, U, t, h):
        """Discrete Jacobians A [K,n,n,B], Bd [K,n,m,B] of one family over
        its knots' X [K,n,B], U [K,m,B], t, h [K].

        Explicit RK4/Euler chain rule over continuous Jacobians taken by
        `torch.func.jacfwd` (`integration.hpp:132-169`).  Stacked (per-knot)
        params map with the knots, shared ones broadcast, and per-instance
        leaves (a trailing batch axis, also on a stacked leaf) map with the
        batch (`batch_axes` of one knot's row).
        """
        if fam.shared:
            pk, pax = None, batch_axes(canon, fp)
        else:
            pk, pax = 0, batch_axes(param_row(canon, 0), param_row(fp, 0))
        n = X.shape[1]
        method = fam.model.method if fam.model is not None else None
        if method not in ("rk4", "euler"):
            jac = jacfwd(fam.fn, argnums=(1, 2))
            return vmap(
                vmap(jac, in_dims=(pax, -1, -1, None, None), out_dims=-1),
                in_dims=(pk, 0, 0, 0, 0), out_dims=0,
            )(fp, X, U, t, h)
        # knots outer, batch inner
        cfn = fam.model.continuous_fn
        cf = vmap(
            vmap(cfn, in_dims=(pax, -1, -1, None), out_dims=-1),
            in_dims=(pk, 0, 0, 0), out_dims=0,
        )
        cj = vmap(
            vmap(jacfwd(cfn, argnums=(1, 2)), in_dims=(pax, -1, -1, None), out_dims=-1),
            in_dims=(pk, 0, 0, 0), out_dims=0,
        )
        hk = h[:, None, None]
        hm = h[:, None, None, None]
        eye = torch.eye(n, dtype=X.dtype, device=X.device)[None, :, :, None]
        if method == "euler":
            Ac, Bc = cj(fp, X, U, t)
            return eye + Ac * hm, Bc * hm
        k1 = cf(fp, X, U, t)
        k2 = cf(fp, X + 0.5 * hk * k1, U, t + 0.5 * h)
        k3 = cf(fp, X + 0.5 * hk * k2, U, t + 0.5 * h)
        A1, B1 = cj(fp, X, U, t)
        A2, B2 = cj(fp, X + 0.5 * hk * k1, U, t + 0.5 * h)
        A3, B3 = cj(fp, X + 0.5 * hk * k2, U, t + 0.5 * h)
        A4, B4 = cj(fp, X + hk * k3, U, t + h)
        dA1 = A1 * hm
        dA2 = mm(A2, eye + 0.5 * dA1) * hm
        dA3 = mm(A3, eye + 0.5 * dA2) * hm
        dA4 = mm(A4, eye + dA3) * hm
        A = eye + (dA1 + 2 * dA2 + 2 * dA3 + dA4) / 6.0
        dB1 = B1 * hm
        dB2 = B2 * hm + 0.5 * mm(A2, dB1) * hm
        dB3 = B3 * hm + 0.5 * mm(A3, dB2) * hm
        dB4 = B4 * hm + mm(A4, dB3) * hm
        Bd = (dB1 + 2 * dB2 + 2 * dB3 + dB4) / 6.0
        return A, Bd

    def dyn_jacobian_all(self, params: ProblemParams, Z: "BatchedTrajectory"):
        """Discrete Jacobians A [N,n,n,B], Bd [N,n,m,B] for all segments:
        each family's over its own knots, scattered into the full arrays
        (`altro_tpu/solver/batched.py:dyn_jacobian_all`); a single family's
        knots are every segment, and its Jacobians are the arrays."""
        canon = self.prob.params.dynamics
        parts = [
            (ks, self._fam_jacobian(fam, canon[fj], params.dynamics[fj],
                                    Z.X[ks], Z.U[ks], Z.t[ks], Z.h[ks]))
            for fj, (fam, ks) in enumerate(zip(self.prob.dynamics_families, self._dyn_knots))
        ]
        if len(parts) == 1:
            return parts[0][1]
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        Bsz = Z.X.shape[-1]
        A = Z.X.new_zeros((N, n, n, Bsz))
        Bd = Z.X.new_zeros((N, n, m, Bsz))
        for ks, (A_f, B_f) in parts:
            A[ks], Bd[ks] = A_f, B_f
        return A, Bd

    # ------------------------------------------------------- cost kernels
    def _upad(self, Z: BatchedTrajectory):
        return torch.cat([Z.U, torch.zeros_like(Z.U[:1])], dim=0)

    def _family_xu(self, fam, Z: BatchedTrajectory):
        ks = self._knots(fam)
        return Z.X[ks], self._upad(Z)[ks]

    def _quad_terms(self, fam, fp, Xk, Uk, want_expansion):
        """Closed-form quadratic cost family, batch-last
        (`quadratic_cost.cpp:8-28`).  Params are shared ([n,n]) or stacked
        per knot ([nk,n,n]), either with a trailing per-instance batch axis
        (told apart by the family's canonical params)."""
        nk, n, Bsz = Xk.shape
        cp = self._canon[id(fam)]

        def norm(name, core_nd):
            # broadcastable [NK, *core, BB] with NK in {1, nk}, BB in {1, B}
            leaf = torch.as_tensor(fp[name]).to(Xk.dtype)
            if not per_instance(cp[name], leaf):
                leaf = leaf[..., None]
            if leaf.ndim != core_nd + 2:
                leaf = leaf[None]  # not per knot
            return leaf

        Q, R, H = norm("Q", 2), norm("R", 2), norm("H", 2)
        q, r, c = norm("q", 1), norm("r", 1), norm("c", 0)

        def matvec(Mat, V):
            return (Mat * V[:, None, :, :]).sum(dim=2)

        def vdot(vec, V):
            return (vec * V).sum(dim=1)

        Qx = matvec(Q, Xk)
        Ru = matvec(R, Uk)
        Hu = matvec(H, Uk)
        Htx = matvec(H.transpose(1, 2), Xk)
        J = (
            0.5 * dotv(Xk, Qx)
            + dotv(Xk, Hu)
            + 0.5 * dotv(Uk, Ru)
            + vdot(q, Xk)
            + vdot(r, Uk)
            + c
        )
        if not want_expansion:
            return J, None

        def bc(Mat):
            return Mat.expand((nk,) + tuple(Mat.shape[1:3]) + (Bsz,))

        lx = Qx + Hu + q
        lu = Ru + Htx + r
        return J, (lx, lu, bc(Q), bc(H), bc(R))

    def _generic_cost_terms(self, fam, fp, Xk, Uk, want_expansion):
        """Arbitrary cost fns: AD expansion, mapped over knots and batch
        (per-instance leaves with the batch)."""

        def one(p, x, u):
            if want_expansion:
                t = (
                    fam.expand_fn(p, x, u)
                    if fam.expand_fn is not None
                    else ad_expansion(fam.fn, p, x, u)
                )
                return t.J, t.lx, t.lu, t.lxx, t.lxu, t.luu
            return (fam.fn(p, x, u),)

        inner = vmap(one, in_dims=(batch_axes(self._canon[id(fam)], fp), -1, -1), out_dims=-1)
        outer = vmap(inner, in_dims=(None if fam.shared else 0, 0, 0), out_dims=0)
        out = outer(fp, Xk, Uk)
        if want_expansion:
            J, lx, lu, lxx, lxu, luu = out
            return J, (lx, lu, lxx, lxu, luu)
        return out[0], None

    def _con_values(self, fam, fp, Xk, Uk):
        """Constraint values [nk, p, B]: the family's `fn`, or for a circle
        family of a `compensated_circles` solver, `comp_circle`; each
        per-instance leaf maps with the batch."""
        structure = fam.constraint.structure if fam.constraint is not None else None
        cp = self._canon[id(fam)]
        if self.compensated_circles and structure is not None and structure[0] == "circle":
            _, xi, yi = structure

            def leaf(key):
                v = torch.as_tensor(fp[key]).to(Xk.dtype)
                return v if per_instance(cp[key], v) else v[..., None]

            cx, cy, r = leaf("cx"), leaf("cy"), leaf("r")
            return comp_circle(Xk[:, xi, None, :] - cx, Xk[:, yi, None, :] - cy, r)
        inner = vmap(fam.fn, in_dims=(batch_axes(cp, fp), -1, -1), out_dims=-1)
        return vmap(inner, in_dims=(None if fam.shared else 0, 0, 0), out_dims=0)(
            fp, Xk, Uk
        )

    def _con_jacs(self, fam, fp, Xk, Uk):
        """Constraint Jacobians ([nk,p,n,B], [nk,p,m,B])."""
        jfn = fam.jac_fn
        if jfn is None:
            jfn = jacfwd(fam.fn, argnums=(1, 2))
        inner = vmap(jfn, in_dims=(batch_axes(self._canon[id(fam)], fp), -1, -1), out_dims=-1)
        return vmap(inner, in_dims=(None if fam.shared else 0, 0, 0), out_dims=0)(
            fp, Xk, Uk
        )

    def _al_terms(self, fam, c, Cx, Cu, lam, rho, want_expansion):
        """AL value/grad/Gauss-Newton Hessian, batch-last
        (`constraint_values.hpp:111-177`); lam [nk, p, B], rho [nk, B]."""
        dual = dual_cone(fam.cone)
        s = lam - rho[:, None, :] * c
        dproj = None
        if dual is Cone.ZERO:
            lam_proj = torch.zeros_like(s)
            dproj = torch.zeros_like(s)
        elif dual is Cone.IDENTITY:
            lam_proj = s
            dproj = torch.ones_like(s)
        elif dual is Cone.SECOND_ORDER:
            lam_proj = soc_project_bl(s)
        else:
            lam_proj = torch.minimum(s, torch.zeros_like(s))
            dproj = torch.where(s > 0, 0.0, 1.0).to(s.dtype)
        J = ((lam_proj * lam_proj).sum(dim=1) - (lam * lam).sum(dim=1)) / (2.0 * rho)
        if not want_expansion:
            return J, None
        if dproj is not None:  # diagonal projection Jacobian
            Jpx = dproj[:, :, None, :] * Cx
            Jpu = dproj[:, :, None, :] * Cu
        else:  # SOC: the dense p×p projection Jacobian (`cone_jacobian`)
            Jp = soc_jacobian_bl(s)
            Jpx = mm(Jp, Cx)
            Jpu = mm(Jp, Cu)
        gx = -(lam_proj[:, :, None, :] * Jpx).sum(dim=1)
        gu = -(lam_proj[:, :, None, :] * Jpu).sum(dim=1)
        rb = rho[:, None, None, :]

        def gram(Ja, Jb):
            return (Ja[:, :, :, None, :] * Jb[:, :, None, :, :]).sum(dim=1)

        return J, (gx, gu, rb * gram(Jpx, Jpx), rb * gram(Jpx, Jpu), rb * gram(Jpu, Jpu))

    # --------------------------------------------------------- assembled ops
    def _cost_family_terms(self, fam, fp, Xk, Uk, want_expansion):
        if fam.fn is _quadcost_eval:
            return self._quad_terms(fam, fp, Xk, Uk, want_expansion)
        return self._generic_cost_terms(fam, fp, Xk, Uk, want_expansion)

    def cost_terms(self, params: ProblemParams, al, Z: BatchedTrajectory):
        """Per-knot AL cost [N+1, B]."""
        N = self.prob.N
        costs = Z.X.new_zeros((N + 1, Z.X.shape[-1]))
        for fam, fp in zip(self.prob.cost_families, params.costs):
            Xk, Uk = self._family_xu(fam, Z)
            J, _ = self._cost_family_terms(fam, fp, Xk, Uk, False)
            costs[self._knots(fam)] += J
        for fam, fp, st in zip(self.prob.constraint_families, params.constraints, al):
            Xk, Uk = self._family_xu(fam, Z)
            c = self._con_values(fam, fp, Xk, Uk)
            J, _ = self._al_terms(fam, c, None, None, st["lam"], st["rho"], False)
            costs[self._knots(fam)] += J
        return costs

    def total_cost(self, params, al, Z):
        return self.cost_terms(params, al, Z).sum(dim=0)  # [B]

    def expand(self, params: ProblemParams, al, Z: BatchedTrajectory):
        """All expansions, batch-last."""
        prob = self.prob
        N, n, m = prob.N, prob.n, prob.m
        Bsz = Z.X.shape[-1]
        z = lambda *shape: Z.X.new_zeros(shape + (Bsz,))  # noqa: E731
        costs, lx, lu = z(N + 1), z(N + 1, n), z(N + 1, m)
        lxx, lxu, luu = z(N + 1, n, n), z(N + 1, n, m), z(N + 1, m, m)

        def acc(ks, J, exp):
            glx, glu, glxx, glxu, gluu = exp
            costs[ks] += J
            lx[ks] += glx
            lu[ks] += glu
            lxx[ks] += glxx
            lxu[ks] += glxu
            luu[ks] += gluu

        for fam, fp in zip(prob.cost_families, params.costs):
            Xk, Uk = self._family_xu(fam, Z)
            acc(self._knots(fam), *self._cost_family_terms(fam, fp, Xk, Uk, True))
        for fam, fp, st in zip(prob.constraint_families, params.constraints, al):
            Xk, Uk = self._family_xu(fam, Z)
            c = self._con_values(fam, fp, Xk, Uk)
            Cx, Cu = self._con_jacs(fam, fp, Xk, Uk)
            acc(self._knots(fam), *self._al_terms(fam, c, Cx, Cu, st["lam"], st["rho"], True))
        A, Bd = self.dyn_jacobian_all(params, Z)
        return dict(costs=costs, lx=lx, lu=lu, lxx=lxx, lxu=lxu, luu=luu, A=A, B=Bd)

    # ------------------------------------------------------------- backward
    def riccati_scan(self, exp, rho):
        """Sequential Riccati sweep, batch-last; rho [B].  Returns
        (K, d, dV1, dV2, failed)."""
        A_all = exp["A"]
        N = A_all.shape[0]
        m = exp["B"].shape[2]
        n = A_all.shape[1]
        Bsz = A_all.shape[-1]
        eye_m = torch.eye(m, dtype=A_all.dtype, device=A_all.device)[:, :, None]
        glim = self.opts.bp_gain_limit
        P = exp["lxx"][N]
        p = exp["lx"][N]
        dV1 = A_all.new_zeros((Bsz,))
        dV2 = A_all.new_zeros((Bsz,))
        failed = torch.zeros((Bsz,), dtype=torch.bool, device=A_all.device)
        K_out = A_all.new_empty((N, m, n, Bsz))
        d_out = A_all.new_empty((N, m, Bsz))
        for k in reversed(range(N)):
            A, Bd = A_all[k], exp["B"][k]
            AtP = mm(mT(A), P)
            Qxx = exp["lxx"][k] + mm(AtP, A)
            Qxu = exp["lxu"][k] + mm(AtP, Bd)
            Quu = exp["luu"][k] + mm(mT(Bd), mm(P, Bd))
            Qx = exp["lx"][k] + mv(mT(A), p)
            Qu = exp["lu"][k] + mv(mT(Bd), p)
            L = chol_unrolled(Quu + eye_m * rho)
            fail_k = chol_failed(L)
            safe = [
                [None if e is None else torch.where(torch.isfinite(e), e, 1.0) for e in row]
                for row in L
            ]
            K = -chol_solve_mat(safe, mT(Qxu))
            d = -chol_solve_vec(safe, Qu)
            # gain-magnitude guard (SolverOptions.bp_gain_limit)
            fail_k = fail_k | ~(K.abs().amax(dim=(0, 1)) <= glim) | ~(
                d.abs().amax(dim=0) <= glim
            )
            KtQuu = mm(mT(K), Quu)
            p_new = Qx + mv(KtQuu, d) + mv(mT(K), Qu) + mv(Qxu, d)
            P_new = Qxx + mm(KtQuu, K) + mm(mT(K), mT(Qxu)) + mm(Qxu, K)
            dV1_new = dV1 + dotv(d, Qu)
            dV2_new = dV2 + 0.5 * dotv(d, mv(Quu, d))
            failed = failed | fail_k
            P = torch.where(failed, P, P_new)
            p = torch.where(failed, p, p_new)
            dV1 = torch.where(failed, dV1, dV1_new)
            dV2 = torch.where(failed, dV2, dV2_new)
            K_out[k] = K
            d_out[k] = d
        return K_out, d_out, dV1, dV2, failed

    def _retry(self, sweep, rho, drho):
        """Regularization retry loop (`ilqr.hpp:385-445`): re-run `sweep(ρ)`
        with ρ [B] increased on the failed lanes until every lane passes or
        gives up.  The sweep is a pure function of ρ, so lanes that passed
        recompute identical results."""
        opts = self.opts
        count = torch.zeros_like(rho, dtype=torch.int32)
        done = torch.zeros_like(rho, dtype=torch.bool)
        out = None
        while out is None or self._any(~done, "bp_retry"):
            res = sweep(rho)
            failed = res[4]
            rho2, drho2 = _increase_reg(rho, drho, opts)
            rho = torch.where(failed, rho2, rho)
            drho = torch.where(failed, drho2, drho)
            count = count + (failed & (rho >= opts.bp_reg_max)).to(torch.int32)
            give_up = failed & (count >= opts.bp_reg_fail_threshold)
            done = (~failed) | give_up
            out = res
        return out, rho, drho

    def backward_pass_fused(self, params, al_pad, Z, rho, drho, kern=None):
        """Backward pass through the fused expansion+Riccati kernel `kern`
        (`ops/backward_fused.py`; None: the solver's own), with the retry
        semantics of :meth:`backward_pass`; the trajectory's AL cost J0
        comes out of the same pass."""
        kern = self._bwd if kern is None else kern
        (K, d, dV1, dV2, failed, J0), rho, drho = self._retry(
            lambda r: kern(params, al_pad, Z, r), rho, drho
        )
        return dict(K=K, d=d, dV1=dV1, dV2=dV2, failed=failed, J0=J0, rho=rho, drho=drho)

    def backward_pass(self, exp, rho, drho):
        """Retry loop with per-instance regularization over the Riccati
        kernel (`ops/riccati.py`) where one was built, else the eager
        sweep."""
        sweep = self.riccati_scan if self._ric is None else self._ric
        (K, d, dV1, dV2, failed), rho, drho = self._retry(
            lambda r: sweep(exp, r), rho, drho
        )
        return dict(K=K, d=d, dV1=dV1, dV2=dV2, failed=failed, rho=rho, drho=drho)

    # ------------------------------------------------------------- forward
    def rollout(self, params: ProblemParams, Z: BatchedTrajectory):
        """Open-loop rollout from x0 under the trajectory's controls."""
        N = Z.U.shape[0]
        x = self._x0(params, Z.X.shape[-1], Z.X.dtype)
        X = [x]
        for k in range(N):
            x = self._step_k(params, k, x, Z.U[k], Z.t[k], Z.h[k])
            X.append(x)
        return Z.replace(X=torch.stack(X, dim=0))

    def closed_loop_rollout(self, params, Z: BatchedTrajectory, K, d, alpha):
        """Feedback rollout with per-instance alpha [B] (`ilqr.hpp:468-499`).
        Returns (Zbar, valid, status)."""
        opts = self.opts
        Bsz = Z.X.shape[-1]
        xbar = self._x0(params, Bsz, Z.X.dtype)
        valid = torch.ones((Bsz,), dtype=torch.bool, device=Z.X.device)
        unsolved = torch.full(
            (Bsz,), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=Z.X.device
        )
        status = unsolved
        Xs, Us = [xbar], []
        for k in range(Z.U.shape[0]):
            ubar = Z.U[k] + mv(K[k], xbar - Z.X[k]) + alpha * d[k]
            xnext = self._step_k(params, k, xbar, ubar, Z.t[k], Z.h[k])
            if opts.check_forwardpass_bounds:
                state_ok = torch.sqrt((xnext * xnext).sum(dim=0)) <= opts.state_max
                ctrl_ok = torch.sqrt((ubar * ubar).sum(dim=0)) <= opts.control_max
            else:
                state_ok = torch.ones_like(valid)
                ctrl_ok = state_ok
            step_ok = state_ok & ctrl_ok
            fail_now = valid & ~step_ok
            status = torch.where(
                fail_now,
                torch.where(
                    ~state_ok,
                    int(SolverStatus.STATE_LIMIT),
                    int(SolverStatus.CONTROL_LIMIT),
                ).to(torch.int32),
                status,
            )
            valid = valid & step_ok
            xbar = torch.where(valid, xnext, xbar)
            Xs.append(xbar)
            Us.append(ubar)
        status = torch.where(valid, unsolved, status)
        Zb = Z.replace(X=torch.stack(Xs, dim=0), U=torch.stack(Us, dim=0))
        return Zb, valid, status

    def _fwd_rollout_cost(self, fwd, params, al_pad, Z, K, d, alpha, check_bounds):
        """Fused rollout + cost through the forward kernel `fwd`; returns
        (Zbar, valid, status, J)."""
        x0 = self._x0(params, Z.X.shape[-1], Z.X.dtype)
        Xn, Ubar, J, valid, status = fwd(
            params, al_pad, Z, K, d, alpha, check_bounds=check_bounds
        )
        Zbar = Z.replace(X=torch.cat([x0[None], Xn], dim=0), U=Ubar)
        return Zbar, valid, status, J

    def forward_pass(self, params, al, Z, bp, J0, rho=None, drho=None, al_pad=None, fwd_kern=None,
                     active=None):
        """Per-instance backtracking line search (`ilqr.hpp:512-558`).

        `rho`/`drho` are the post-decrease regularization; a failed search
        increases them from there.  With the forward kernel `fwd_kern` and
        `al_pad` (the padded AL state of the inner solve) the kernel runs
        every lane's whole search in one launch (`_line_search_device`),
        searching only the lanes of `active` [B] (None: every lane; the
        inner loop passes its own, and never reads the others' results),
        and with `line_search_parallel` S > 1, S tries of every lane run in
        one launch a round (`_line_search_speculative`); without the
        kernel, the eager rollout + cost, one try at a time (the JAX
        package's scan path ignores S too).  The kernel's two searches
        accept what the lockstep search over the kernel accepts, bit for
        bit.
        """
        opts = self.opts
        S = int(opts.line_search_parallel)
        if fwd_kern is not None and S > 1:
            c = self._line_search_speculative(fwd_kern, params, al_pad, Z, bp, J0, S)
        elif fwd_kern is not None:
            c = self._line_search_device(fwd_kern, params, al_pad, Z, bp, J0, active)
        else:
            c = self._line_search_sequential(fwd_kern, params, al, al_pad, Z, bp, J0)
        rho = bp["rho"] if rho is None else rho
        drho = bp["drho"] if drho is None else drho
        Z_out = zselect(c["success"], c["Zbar"], Z)
        rho_i, drho_i = _increase_reg(rho, drho, opts)
        rho = torch.where(c["success"], rho, rho_i)
        drho = torch.where(c["success"], drho, drho_i)
        J_final = torch.where(c["success"], c["J"], J0)
        status = torch.where(
            J_final > J0, int(SolverStatus.COST_INCREASE), c["status"]
        ).to(torch.int32)
        return dict(
            Z=Z_out, J=J_final, alpha=c["alpha"], z=c["z"],
            success=c["success"], rho=rho, drho=drho, status=status,
        )

    def _search_init(self, Z, J0) -> dict:
        """The line search's carry before its first try."""
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        dev = Z.X.device
        return dict(
            it=torch.zeros((Bsz,), dtype=torch.int32, device=dev),
            alpha=torch.ones((Bsz,), dtype=dt, device=dev),
            success=torch.zeros((Bsz,), dtype=torch.bool, device=dev),
            J=J0,
            z=-torch.ones((Bsz,), dtype=dt, device=dev),
            status=torch.full((Bsz,), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=dev),
            Zbar=Z,
        )

    def _line_search_sequential(self, fwd, params, al, al_pad, Z, bp, J0) -> dict:
        """One try per round, α divided by the decrease factor after each
        rejection; one host sync per round."""
        opts = self.opts
        max_it = opts.line_search_max_iterations
        c = self._search_init(Z, J0)
        more = max_it > 0  # every lane is active on the first try
        while more:
            active = (~c["success"]) & (c["it"] < max_it)
            if fwd is not None:
                Zbar, valid, status, J_try = self._fwd_rollout_cost(
                    fwd, params, al_pad, Z, bp["K"], bp["d"], c["alpha"],
                    opts.check_forwardpass_bounds,
                )
            else:
                Zbar, valid, status = self.closed_loop_rollout(
                    params, Z, bp["K"], bp["d"], c["alpha"]
                )
                J_try = self.total_cost(params, al, Zbar)
            c = search_round(opts, c, active, J0, bp["dV1"], bp["dV2"], Zbar, valid, status, J_try)
            more = self._any((~c["success"]) & (c["it"] < max_it), "line_search")
        return c

    def _line_search_device(self, fwd, params, al_pad, Z, bp, J0, active) -> dict:
        """The whole search of every lane of `active` (None: every lane) in
        one forward-kernel launch (`ForwardKernel.search`), with no host
        sync: each lane stops at its own accepted try or at the search's
        budget, and a lane outside `active` runs no try (its results are
        the search's starting values, with an unwritten trajectory).  On
        the lanes it searches it leaves what `_line_search_sequential`
        leaves, bit for bit."""
        Bsz = Z.X.shape[-1]
        max_it = self.opts.line_search_max_iterations
        if active is None:
            budget = torch.full((Bsz,), max_it, dtype=torch.int32, device=Z.X.device)
        else:
            budget = torch.where(active, max_it, 0).to(torch.int32)
        out = fwd.search(params, al_pad, Z, bp["K"], bp["d"], J0, bp["dV1"], bp["dV2"], Z.X.new_ones((Bsz,)),
                         budget)
        x0 = self._x0(params, Bsz, Z.X.dtype)
        return dict(
            it=out["tries"], success=out["success"], alpha=out["alpha"], J=out["J"], z=out["z"],
            status=out["status"], Zbar=Z.replace(X=torch.cat([x0[None], out["Xn"]], dim=0), U=out["Ubar"]),
        )

    def _widened(self, params, al_pad, S: int):
        """`params` and `al_pad` at S·B lanes, candidate-major (lane j·B + b
        is instance b): every per-instance leaf (x0 included, `batch_axes`)
        and the AL buffers tiled S times, shared leaves as they are.  Kept
        with the objects they came from, so a solve widens its params once
        (and the lane-params kernel builds one lane table of S·B lanes) and
        an inner solve its AL state once, as the JAX package tiles them once
        per line search (`altro_tpu/solver/batched.py:1238-1248`)."""
        tile = lambda leaf: _tile(leaf, S)  # noqa: E731
        if self._spec_params is None or self._spec_params[0] is not params or self._spec_params[1] != S:
            canon = self.prob.params
            wide = lambda c, leaf: tile(leaf) if per_instance(c, leaf) else leaf  # noqa: E731
            params_s = ProblemParams(*(_tree_map2(wide, getattr(canon, f.name), getattr(params, f.name))
                                       for f in dataclasses.fields(params)))
            self._spec_params = (params, S, params_s)
        if self._spec_al is None or self._spec_al[0] is not al_pad or self._spec_al[1] != S:
            opt = lambda t: None if t is None else tile(t)  # noqa: E731
            al_s = dataclasses.replace(
                al_pad, lam=opt(al_pad.lam), rho=opt(al_pad.rho), lamT=opt(al_pad.lamT),
                rhoT=opt(al_pad.rhoT),
                al=tuple(dict(lam=tile(st["lam"]), rho=tile(st["rho"])) for st in al_pad.al),
            )
            self._spec_al = (al_pad, S, al_s)
        return self._spec_params[2], self._spec_al[2]

    def _line_search_speculative(self, fwd, params, al_pad, Z, bp, J0, S: int) -> dict:
        """Speculative backtracking line search
        (`altro_tpu/solver/batched.py:_line_search_speculative`): S
        candidate step sizes α, α/f, …, α/f^(S-1) (f the decrease factor,
        each candidate the one before it divided by f, as the sequential
        search divides) go through one forward-kernel launch at S·B lanes,
        and each lane takes its first passing candidate: the α, the tries
        and the trajectory that the sequential search accepts, bit for bit,
        since a lane's kernel result does not depend on its slot and the
        pick is an index, not a sum.  Another round runs only where a lane
        rejected all S; a candidate counts only within the search's
        iteration budget.  One host sync per round."""
        opts = self.opts
        Bsz = Z.X.shape[-1]
        dev = Z.X.device
        max_it = opts.line_search_max_iterations
        params_s, al_pad_s = self._widened(params, al_pad, S)
        # the base trajectory and the gains are fixed for the whole search
        Z_s = Z.replace(X=_tile(Z.X, S), U=_tile(Z.U, S))
        K_s, d_s = _tile(bp["K"], S), _tile(bp["d"], S)
        cand = torch.arange(S, dtype=torch.int32, device=dev)[:, None]  # [S, 1]
        lane = torch.arange(Bsz, device=dev)
        c = self._search_init(Z, J0)
        more = max_it > 0
        while more:
            active = (~c["success"]) & (c["it"] < max_it)
            alphas = [c["alpha"]]
            for _ in range(S):
                alphas.append(alphas[-1] / opts.line_search_decrease_factor)
            alphas = torch.stack(alphas)  # [S+1, B]: the S candidates and the next
            a = alphas[:S]
            Zbar_s, valid_s, status_s, J_s = self._fwd_rollout_cost(
                fwd, params_s, al_pad_s, Z_s, K_s, d_s, a.reshape(S * Bsz),
                opts.check_forwardpass_bounds,
            )
            J_c = J_s.reshape(S, Bsz)
            valid = valid_s.reshape(S, Bsz)
            expected = -a * (bp["dV1"] + a * bp["dV2"])
            z = torch.where(expected > 0.0, (J0 - J_c) / expected, -torch.ones_like(J_c))
            # candidate j is a real try only if the sequential search would
            # still be within its budget at try it + j
            tried = (c["it"] + cand) < max_it
            ok = (
                valid
                & (opts.line_search_lower_bound <= z)
                & (z <= opts.line_search_upper_bound)
                & (J_c < J0)
                & tried
            )
            any_ok = ok.any(dim=0)
            first_ok = torch.where(ok, cand, S).amin(dim=0)
            n_tried = tried.sum(dim=0, dtype=torch.int32)
            sel = torch.where(any_ok, first_ok, (n_tried - 1).clamp(min=0)).long()

            def pick(leaf):  # [..., S·B] -> [..., B]: each lane's candidate `sel`
                return leaf.reshape(leaf.shape[:-1] + (S, Bsz))[..., sel, lane]

            J_sel = pick(J_s)
            valid_sel = pick(valid_s)
            c = dict(
                it=torch.where(active, c["it"] + torch.where(any_ok, first_ok + 1, n_tried), c["it"]),
                success=torch.where(active, any_ok, c["success"]),
                alpha=torch.where(
                    active, torch.where(any_ok, a[sel, lane], alphas[n_tried.long(), lane]), c["alpha"]
                ),
                J=torch.where(active & valid_sel, J_sel, c["J"]),
                z=torch.where(active, z[sel, lane], c["z"]),
                status=torch.where(active, pick(status_s), c["status"]),
                Zbar=zselect(active, Z.replace(X=pick(Zbar_s.X), U=pick(Zbar_s.U)), c["Zbar"]),
            )
            more = self._any((~c["success"]) & (c["it"] < max_it), "line_search")
        return c

    # ------------------------------------------------------------- inner solve
    def ilqr_solve(self, params, al, Z, stats: BatchedStats, outer_active, lane_opts=None):
        """Masked batched inner solve; `outer_active` [B] gates instances.
        `lane_opts` may set `max_iterations_total` per lane (see `solve`)."""
        opts = self.opts
        max_total = (lane_opts or {}).get("max_iterations_total", opts.max_iterations_total)
        dt = Z.X.dtype
        dev = Z.X.device
        Bsz = Z.X.shape[-1]
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        # the kernels run when they take this solve's per-instance leaves
        fwd = self._fwd if self._fwd is not None and self._fwd.takes(params) else None
        bwd = self._bwd if self._bwd is not None and self._bwd.takes(params) else None
        al_pad = None
        if bwd is not None:
            al_pad = bwd.pad_al(al)
        elif fwd is not None:
            al_pad = fwd.pad_al(al)
        with span("ilqr.rollout"):
            if fwd is not None:
                # K=d=α=0 turns the fused kernel into the open-loop rollout + cost
                # (unguarded, like the reference's Rollout, `ilqr.hpp:453-459`)
                Zro, _, _, J_init = self._fwd_rollout_cost(
                    fwd, params, al_pad, Z, Z.X.new_zeros((N, m, n, Bsz)),
                    Z.X.new_zeros((N, m, Bsz)), Z.X.new_zeros((Bsz,)), False,
                )
                Z = zselect(outer_active, Zro, Z)
            else:
                Z = zselect(outer_active, self.rollout(params, Z), Z)
                J_init = self.total_cost(params, al, Z)
        stats = stats.replace(
            initial_cost=torch.where(outer_active, J_init, stats.initial_cost),
            iterations_inner=torch.where(outer_active, 0, stats.iterations_inner).to(torch.int32),
        )
        c = dict(
            Z=Z,
            rho=torch.full((Bsz,), opts.bp_reg_initial, dtype=dt, device=dev),
            drho=torch.zeros((Bsz,), dtype=dt, device=dev),
            stats=stats,
            cost_last=J_init,
            status=torch.full((Bsz,), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=dev),
            done=~outer_active,
            stall=torch.zeros((Bsz,), dtype=torch.int32, device=dev),
            K=Z.X.new_zeros((N, m, n, Bsz)),
            d=Z.X.new_zeros((N, m, Bsz)),
        )
        while self._any(~c["done"], "inner_exit"):
            with span("ilqr.iter"):
                active = ~c["done"]
                stats = c["stats"]
                with span("ilqr.backward"):
                    if bwd is not None:
                        # expansions inside the sweep; J0 from the kernel's Kahan sum
                        bp = self.backward_pass_fused(params, al_pad, c["Z"], c["rho"], c["drho"], bwd)
                        J0 = bp["J0"]
                    else:
                        exp = self.expand(params, al, c["Z"])
                        J0 = exp["costs"].sum(dim=0)
                        bp = self.backward_pass(exp, c["rho"], c["drho"])
                rho_d, drho_d = _decrease_reg(bp["rho"], bp["drho"], opts)
                with span("ilqr.forward"):
                    fp = self.forward_pass(params, al, c["Z"], bp, J0, rho_d, drho_d, al_pad, fwd, active=active)
                status = torch.where(
                    bp["failed"], int(SolverStatus.BACKWARD_PASS_REGULARIZATION_FAILED),
                    fp["status"],
                ).to(torch.int32)
                cost_new = torch.where(fp["success"], fp["J"], c["cost_last"])
                grad = (bp["d"].abs() / (fp["Z"].U.abs() + 1.0)).amax(dim=1).mean(dim=0)
                dJ = c["cost_last"] - cost_new
                step = active.to(torch.int32)
                inner = stats.iterations_inner + step
                total = stats.iterations_total + step

                small_dj = dJ < opts.cost_tolerance
                converged = small_dj & (grad < opts.gradient_tolerance)
                stall = torch.where(
                    active & small_dj, c["stall"] + 1, torch.where(active, 0, c["stall"])
                ).to(torch.int32)
                if opts.max_stall_iterations > 0:
                    stalled = (stall >= opts.max_stall_iterations) & ~converged
                else:
                    stalled = torch.zeros_like(converged)
                hit_inner = inner >= opts.max_iterations_inner
                hit_total = total >= max_total
                bad = status != int(SolverStatus.UNSOLVED)
                status = torch.where(
                    converged, int(SolverStatus.SOLVED),
                    torch.where(
                        stalled, int(SolverStatus.SOLVED_STALLED),
                        torch.where(
                            hit_inner, int(SolverStatus.MAX_INNER_ITERATIONS),
                            torch.where(hit_total, int(SolverStatus.MAX_ITERATIONS), status),
                        ),
                    ),
                ).to(torch.int32)
                done_new = converged | stalled | hit_inner | hit_total | bad
                stats = stats.replace(
                    iterations_inner=torch.where(active, inner, stats.iterations_inner),
                    iterations_total=torch.where(active, total, stats.iterations_total),
                    cost=torch.where(active, cost_new, stats.cost),
                    cost_decrease=torch.where(active, dJ, stats.cost_decrease),
                    gradient=torch.where(active, grad, stats.gradient),
                    alpha=torch.where(active & fp["success"], fp["alpha"], stats.alpha),
                    improvement_ratio=torch.where(
                        active & fp["success"], fp["z"], stats.improvement_ratio
                    ),
                    regularization=torch.where(active, bp["rho"], stats.regularization),
                )
                stats = _record_history(stats, active)
                if self._logger is not None:
                    self._emit_inner_row(active, stats)
                c = dict(
                    Z=zselect(active, fp["Z"], c["Z"]),
                    rho=torch.where(active, fp["rho"], c["rho"]),
                    drho=torch.where(active, fp["drho"], c["drho"]),
                    stats=stats,
                    cost_last=torch.where(active, cost_new, c["cost_last"]),
                    status=torch.where(active, status, c["status"]),
                    done=c["done"] | (active & done_new),
                    stall=stall,
                    K=torch.where(active, bp["K"], c["K"]),
                    d=torch.where(active, bp["d"], c["d"]),
                )
        return c

    # ------------------------------------------------------------- AL outer
    def al_state_init(self, Bsz: int, dtype, device=None) -> tuple:
        device = self.device if device is None else device
        return tuple(
            dict(
                lam=torch.zeros((len(fam.knots), fam.dim, Bsz), dtype=dtype, device=device),
                rho=torch.full(
                    (len(fam.knots), Bsz), self.opts.initial_penalty, dtype=dtype, device=device
                ),
            )
            for fam in self.prob.constraint_families
        )

    def constraint_values(self, params, Z):
        return tuple(
            self._con_values(fam, fp, *self._family_xu(fam, Z))
            for fam, fp in zip(self.prob.constraint_families, params.constraints)
        )

    def _outer_duals_and_violation(self, params, Z, al, upd):
        """Dual update λ ← Π_{K*}(λ−ρc) and the max-violation measure of
        the outer loop; in float64 when `opts.outer_constraints_f64` (the
        f32 error in c is penalty-amplified exactly here).  Returns
        (al_new tuple, viol [B])."""
        dt = Z.X.dtype
        Bsz = Z.X.shape[-1]
        cdt = dt
        if self.opts.outer_constraints_f64 and dt == torch.float32:
            cdt = torch.float64
            params = params.astype(cdt)
            Z = Z.replace(X=Z.X.to(cdt), U=Z.U.to(cdt), t=Z.t.to(cdt), h=Z.h.to(cdt))
        cvals = self.constraint_values(params, Z)
        al_new = []
        for fam, st, cv in zip(self.prob.constraint_families, al, cvals):
            dual = dual_cone(fam.cone)
            s = st["lam"].to(cdt) - st["rho"].to(cdt)[:, None, :] * cv
            if dual is Cone.IDENTITY:
                lam = s
            elif dual is Cone.ZERO:
                lam = torch.zeros_like(s)
            elif dual is Cone.SECOND_ORDER:
                lam = soc_project_bl(s)
            else:
                lam = torch.minimum(s, torch.zeros_like(s))
            al_new.append(dict(lam=torch.where(upd, lam.to(dt), st["lam"]), rho=st["rho"]))
        viol = self.max_violation(cvals, Bsz, cdt).to(dt)
        return tuple(al_new), viol

    def max_violation(self, cvals, Bsz, dtype):
        viol = torch.zeros((Bsz,), dtype=dtype, device=self.device)
        for fam, c in zip(self.prob.constraint_families, cvals):
            if fam.cone is Cone.ZERO:
                v = c.abs()
            elif fam.cone is Cone.NEGATIVE_ORTHANT:
                v = torch.clamp(c, min=0.0)
            elif fam.cone is Cone.SECOND_ORDER:
                v = (c - soc_project_bl(c)).abs()
            else:  # IDENTITY: whole space, never violated
                continue
            viol = torch.maximum(viol, v.amax(dim=(0, 1)).to(dtype))
        return viol

    def solve(self, params: ProblemParams, Z: BatchedTrajectory, al=None, active=None,
              lane_opts=None):
        """Full batched AL solve.  Returns a dict with batch-last results.

        `active` [B] (optional) gates instances: inactive lanes are never
        iterated and pass their inputs through — used by the compaction
        tail (`solver/compaction.py`) where padding lanes hold finished
        instances.

        `lane_opts` (optional dict of [B] tensors) sets options per lane:
        `penalty_scaling`, `max_iterations_outer`, `max_iterations_total`
        (`altro_tpu/solver/batched.py:1689-1705`); the restart portfolio
        (`solver/compaction.py`) runs its variants with them.
        """
        reads = host_reads()
        counts = search_counts(Z.X.device) if self._fwd is not None else None
        start = None if counts is None else counts.clone()
        try:
            with root_span("al.solve"):
                return self._solve(params, Z, al, active, lane_opts)
        finally:
            self.host_syncs = host_reads() - reads
            self.ls_counts = None if counts is None else counts - start

    @property
    def ls_tries(self) -> float | None:
        """Tries per searched lane of the last solve's forward-kernel line
        searches (None where none ran): a host read of `ls_counts`, the
        solve's (tries, searched lanes, lane tries run) on the device, so
        ask for it outside the timed path."""
        return None if self.ls_counts is None else _ls_tries(self.ls_counts.tolist())

    @property
    def ls_block_tries(self) -> float | None:
        """Lane tries the forward kernel's blocks ran per searched lane in
        the last solve (`utils/timer.py:ls_block_tries`), read as
        `ls_tries` is."""
        return None if self.ls_counts is None else _ls_block_tries(self.ls_counts.tolist())

    def _solve(self, params, Z, al, active, lane_opts):
        opts = self.opts
        dt = Z.X.dtype
        dev = Z.X.device
        Bsz = Z.X.shape[-1]
        lane_opts = lane_opts or {}
        ps_lane = lane_opts.get("penalty_scaling", opts.penalty_scaling)
        if torch.is_tensor(ps_lane):
            ps_lane = ps_lane.to(dt)
        max_outer = lane_opts.get("max_iterations_outer", opts.max_iterations_outer)
        max_total = lane_opts.get("max_iterations_total", opts.max_iterations_total)
        N, n, m = self.prob.N, self.prob.n, self.prob.m
        if active is None:
            active0 = torch.ones((Bsz,), dtype=torch.bool, device=dev)
        else:
            active0 = active.to(torch.bool)
        if al is None:
            al = self.al_state_init(Bsz, dt, dev)
        else:
            if opts.reset_duals:
                al = tuple(dict(lam=torch.zeros_like(s["lam"]), rho=s["rho"]) for s in al)
            if opts.initial_penalty > 0:
                al = tuple(
                    dict(lam=s["lam"], rho=torch.full_like(s["rho"], opts.initial_penalty))
                    for s in al
                )
        stats = batched_stats_init(Bsz, dt, opts.iteration_history_capacity, dev)
        if opts.iteration_history_capacity > 0 and self.prob.constraint_families:
            # seed the violation and penalty columns as the per-instance
            # solver's pre-solve log does (`altro_tpu/solver/batched.py:1725-1735`)
            pen0 = Z.X.new_zeros((Bsz,))
            for st in al:
                pen0 = torch.maximum(pen0, st["rho"].amax(dim=0))
            stats = stats.replace(
                violations=self.max_violation(self.constraint_values(params, Z), Bsz, dt),
                max_penalty=pen0,
            )
        if not self.prob.constraint_families:
            out = self.ilqr_solve(params, al, Z, stats, active0, lane_opts)
            return dict(
                Z=out["Z"], al=al, status=out["status"], stats=out["stats"],
                K=out["K"], d=out["d"],
            )

        c = dict(
            Z=Z, al=al, stats=stats,
            status=torch.full((Bsz,), int(SolverStatus.UNSOLVED), dtype=torch.int32, device=dev),
            done=~active0,
            K=Z.X.new_zeros((N, m, n, Bsz)),
            d=Z.X.new_zeros((N, m, Bsz)),
        )
        while self._any(~c["done"], "outer_exit"):
            with span("al.outer"):
                active = ~c["done"]
                res = self.ilqr_solve(params, c["al"], c["Z"], c["stats"], active, lane_opts)
                Z2 = res["Z"]
                stats = res["stats"]
                inner_solved = res["status"] == int(SolverStatus.SOLVED)
                # a stall-exited inner solve continues the outer loop but
                # taints the final status to SOLVED_STALLED
                inner_ok = inner_solved | (res["status"] == int(SolverStatus.SOLVED_STALLED))
                # the duals, violations, statuses and penalties of the lanes that ran
                with span("al.duals"):
                    upd = active if opts.update_duals_on_failed_inner else (active & inner_ok)
                    al_new, viol = self._outer_duals_and_violation(params, Z2, c["al"], upd)
                    pen = Z.X.new_zeros((Bsz,))
                    for st in al_new:
                        pen = torch.maximum(pen, st["rho"].amax(dim=0))
                    outer = stats.iterations_outer + active.to(torch.int32)
                    stats = stats.replace(
                        iterations_outer=torch.where(active, outer, stats.iterations_outer),
                        violations=torch.where(active, viol, stats.violations),
                        max_penalty=torch.where(active, pen, stats.max_penalty),
                    )
                    sat = viol < opts.constraint_tolerance
                    pen_hi = pen > opts.maximum_penalty
                    outer_hi = outer >= max_outer
                    total_hi = stats.iterations_total >= max_total
                    # stalled_feasible_exits=False: a feasible-but-stalled instance
                    # keeps escalating the penalty until its inner solve converges
                    sat_done = sat if opts.stalled_feasible_exits else (sat & inner_solved)
                    status = torch.where(
                        ~inner_ok, res["status"],
                        torch.where(
                            sat_done,
                            torch.where(
                                inner_solved, int(SolverStatus.SOLVED),
                                int(SolverStatus.SOLVED_STALLED),
                            ),
                            torch.where(
                                pen_hi, int(SolverStatus.MAX_PENALTY),
                                torch.where(
                                    outer_hi, int(SolverStatus.MAX_OUTER_ITERATIONS),
                                    torch.where(
                                        total_hi, int(SolverStatus.MAX_ITERATIONS),
                                        int(SolverStatus.UNSOLVED),
                                    ),
                                ),
                            ),
                        ),
                    ).to(torch.int32)
                    if not opts.stalled_feasible_exits:
                        # a cap ending a continuing feasible-stalled instance keeps
                        # the SOLVED_STALLED label
                        capped = pen_hi | outer_hi | total_hi
                        status = torch.where(
                            inner_ok & sat & ~sat_done & capped,
                            int(SolverStatus.SOLVED_STALLED), status,
                        ).to(torch.int32)
                    done_new = (~inner_ok) | sat_done | pen_hi | outer_hi | total_hi
                    # scale penalties only for continuing instances
                    cont = active & ~done_new
                    if self._logger is not None:
                        self._emit_outer_row(cont, torch.where(active, status, c["status"]), stats)
                    al_next = tuple(
                        dict(lam=st["lam"], rho=torch.where(cont, st["rho"] * ps_lane, st["rho"]))
                        for st in al_new
                    )
                c = dict(
                    Z=zselect(active, Z2, c["Z"]),
                    al=al_select(active, al_next, c["al"]),
                    stats=stats,
                    status=torch.where(active, status, c["status"]),
                    done=c["done"] | (active & done_new),
                    K=torch.where(active, res["K"], c["K"]),
                    d=torch.where(active, res["d"], c["d"]),
                )
        return dict(
            Z=c["Z"], al=c["al"], status=c["status"], stats=c["stats"], K=c["K"], d=c["d"],
        )


def search_round(opts: SolverOptions, c: dict, active, J0, dV1, dV2, Zbar, valid, status, J_try) -> dict:
    """One round of the lockstep line search: the lanes of `active` test
    their try (`Zbar`, `valid`, `status`, its cost `J_try`) against J0 and
    the expected decrease −α(ΔV1 + αΔV2); a rejection divides α by the
    decrease factor.  The search's carry `c` as `_search_init` makes it."""
    J = torch.where(valid, J_try, c["J"])
    expected = -c["alpha"] * (dV1 + c["alpha"] * dV2)
    z = torch.where(expected > 0.0, (J0 - J_try) / expected, -torch.ones_like(J0))
    ok = (
        valid
        & (opts.line_search_lower_bound <= z)
        & (z <= opts.line_search_upper_bound)
        & (J_try < J0)
    )
    return dict(
        it=c["it"] + active.to(torch.int32),
        success=torch.where(active, ok, c["success"]),
        alpha=torch.where(active & ~ok, c["alpha"] / opts.line_search_decrease_factor, c["alpha"]),
        J=torch.where(active, J, c["J"]),
        z=torch.where(active, z, c["z"]),
        status=torch.where(active, status, c["status"]),
        Zbar=zselect(active, Zbar, c["Zbar"]),
    )


def _knot_slice(knots):
    """`knots` as a slice where they are contiguous, else None."""
    k = np.asarray(knots)
    if k.size and bool((np.diff(k) == 1).all()):
        return slice(int(k[0]), int(k[-1]) + 1)
    return None


def _tile(leaf: torch.Tensor, S: int) -> torch.Tensor:
    """[..., B] -> [..., S·B], candidate-major: S copies side by side."""
    return leaf.repeat(*([1] * (leaf.ndim - 1)), S)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median as numpy and the JAX package take it: the mean of the two
    middle values of an even count."""
    return torch.quantile(x.to(torch.float64), 0.5)


def _increase_reg(rho, drho, opts: SolverOptions):
    drho = torch.clamp(drho * opts.bp_reg_increase_factor, min=opts.bp_reg_increase_factor)
    rho = torch.clamp(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho


def _decrease_reg(rho, drho, opts: SolverOptions):
    drho = torch.clamp(
        drho / opts.bp_reg_increase_factor, max=1.0 / opts.bp_reg_increase_factor
    )
    rho = torch.clamp(rho * drho, opts.bp_reg_min, opts.bp_reg_max)
    return rho, drho
