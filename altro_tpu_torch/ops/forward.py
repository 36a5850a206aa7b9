"""Fused closed-loop rollout + cost kernel (CUDA, `csrc/forward.cuh`).

Replaces the TPU kernel `altro_tpu/ops/forward_pallas.py:ForwardKernel`
(body `_make_kernel(check_bounds)`, :534-685).  One thread per batch lane
runs a whole line-search try: the feedback control, the stage cost and AL
terms, the RK4 step and the divergence guard at each knot, then the
terminal terms, with the state carry in registers and J Kahan-summed.  With
α = 0 and K = d = 0 (and `check_bounds=False`) it is the open-loop rollout
that starts each inner solve.  `search` runs a lane's whole backtracking
line search in one launch instead: the kernel's search mode tests each try
on the device and runs the next only for the lanes of a block that still
search, so a search costs no host round trip and a block no more tries than
its slowest lane.

What bounds it on the H100 is the latency of each lane's chain (numbers in
`csrc/forward.cuh`); the streamed bytes are small.  A block owns LANES
lanes: one warp runs their chains over a chunk of knots from shared
memory, while the other adds the previous chunk's cost terms, off the
chain, and copies the next chunk's inputs in with cp.async.  B >= 2048
fills the card's 132 multiprocessors (`geometry`).  `chain_only=True`
times the chain alone.

Eligibility, the problem descriptor, `pad_al`, the per-instance
signature (`param_sig`, `takes`), the lane table and the geometry's
bookkeeping are shared with the backward kernel
(`ops/backward_fused.py:FusedKernel`).  Params with per-lane leaves launch
the lane-params instantiation, whose staging warp copies a knot's lane
rows with its inputs and whose chain reads its lane's dynamics params once,
before the first knot.  Beside the kernel: its plain
PyTorch version (`plain`: `closed_loop_rollout` + `total_cost`, circle
rows through `comp_circle` as in the kernel), which the wrapper runs only
for CPU tensors, and a launch counter.
"""
from __future__ import annotations

import torch

from ..utils.timer import PLAIN_SEARCH, host_read, search_counts
from . import _build
from .backward_fused import (
    FWD_THREADS, LANES, SMEM_MAX, STAGE_WORDS, TABLE_SMEM, FusedKernel, Geometry, Ineligible, PaddedAL,
    _ptr, chunk_knots, forward_smem,
)

__all__ = ["ForwardKernel", "Ineligible", "build_forward_kernel"]


class ForwardKernel(FusedKernel):
    """`__call__(params, al_pad, Z, K, d, alpha, check_bounds=)` returns
    `(Xnext [N,n,B], Ubar [N,m,B], J [B], valid [B] bool, status [B] int32)`,
    equal to `closed_loop_rollout` + `total_cost` (circle rows through
    `comp_circle`) up to rounding."""

    KIND = "forward"

    def _chunk_knots(self, lane=None) -> int:
        """Knots per chunk: at most STAGE_WORDS staged input words, the
        per-lane rows of a knot (`lane` = (knot rows, static rows))
        included."""
        n, m, item, Ps, Fs = self.n, self.m, self._itemsize, self.Ps, self.Fs
        W = lane[0] if lane is not None else 0
        return chunk_knots(
            LANES * (n + 2 * m + m * n + Ps + Fs + W), STAGE_WORDS,
            lambda knots: forward_smem(n, m, item, LANES, knots, TABLE_SMEM // item, Ps, Fs, lane),
        )

    def _layout(self, tab: int, lane=None) -> Geometry:
        """Two warps per block, the first LANES threads of each running the
        lanes' rollouts and their cost terms, with `tab` cost-table entries
        staged and `lane` = (knot rows, static rows) of a lane table (None:
        the shared-param instantiation)."""
        n, m, item = self.n, self.m, self._itemsize
        knots = self._chunk_knots(lane)
        smem = forward_smem(n, m, item, LANES, knots, tab, self.Ps, self.Fs, lane)
        if smem > SMEM_MAX:  # beyond every layout `param_sig` admits
            raise ValueError(f"{smem} bytes of shared memory for one chunk of knots")
        return Geometry(lanes=LANES, knots=knots, group=1, threads=FWD_THREADS, smem=smem, tab_smem=tab)

    @staticmethod
    def _alpha(alpha, Z) -> torch.Tensor:
        alpha = torch.as_tensor(alpha, dtype=Z.X.dtype, device=Z.X.device)
        return alpha.expand(Z.X.shape[-1]).contiguous() if alpha.ndim == 0 else alpha

    def plain(self, params, al_pad: PaddedAL, Z, K, d, alpha, *, check_bounds=True):
        """The plain PyTorch version of the kernel."""
        ev = self._eager_solver(check_bounds)
        Zbar, valid, status = ev.closed_loop_rollout(params, Z, K, d, self._alpha(alpha, Z))
        J = ev.total_cost(params, al_pad.al, Zbar)
        return Zbar.X[1:], Zbar.U, J, valid, status

    def __call__(self, params, al_pad: PaddedAL, Z, K, d, alpha, *, check_bounds=True,
                 chain_only=False):
        """`chain_only` times the rollout's chain alone: the kernel replays
        its first chunk of inputs for every chunk, so the outputs are wrong
        (csrc/forward.cuh); the plain version has no such mode."""
        if self._use_plain(Z.X):
            if chain_only:
                raise ValueError("chain_only exists only for the CUDA kernel")
            return self.plain(params, al_pad, Z, K, d, alpha, check_bounds=check_bounds)
        args, outs, sig, lane_tab = self._rollout_args(params, al_pad, Z, K, d, alpha, check_bounds)
        args.chain_only = int(bool(chain_only))
        self._launch(args, sig, lane_tab, Z.X)
        Xn, Ubar, J, valid, status = outs
        return Xn, Ubar, J, valid != 0, status

    def _rollout_args(self, params, al_pad: PaddedAL, Z, K, d, alpha, check_bounds):
        """The launch's args struct for a try at `alpha` per lane, its
        outputs (Xn, Ubar, J, valid, status) and the prepared signature and
        lane table."""
        N, n, m = self.N, self.n, self.m
        B = Z.X.shape[-1]
        x0 = params.x0
        if x0.ndim == 1:
            x0 = x0[:, None].expand(n, B)
        x0 = x0.to(Z.X.dtype).contiguous()
        alpha = self._alpha(alpha, Z)
        self._check("t", Z.t, (N + 1,))
        self._check("h", Z.h, (N,))
        self._check("x0", x0, (n, B))
        self._check("alpha", alpha, (B,))
        self._check("X", Z.X, (N + 1, n, B))
        self._check("U", Z.U, (N, m, B))
        self._check("K", K, (N, m, n, B))
        self._check("d", d, (N, m, B))
        self._check_al(al_pad, B)
        sig, table, lane_tab = self._prepare(params, B)
        new = Z.X.new_empty
        Xn, Ubar, J = new((N, n, B)), new((N, m, B)), new((B,))
        valid = torch.empty((B,), dtype=torch.int32, device=Z.X.device)
        status = torch.empty((B,), dtype=torch.int32, device=Z.X.device)
        args = _build.ForwardArgs(
            cost_tab=_ptr(table), t=_ptr(Z.t), h=_ptr(Z.h), x0=_ptr(x0), alpha=_ptr(alpha),
            X=_ptr(Z.X), U=_ptr(Z.U), K=_ptr(K), d=_ptr(d),
            lam=_ptr(al_pad.lam), lam_rho=_ptr(al_pad.rho),
            lamT=_ptr(al_pad.lamT), lamT_rho=_ptr(al_pad.rhoT),
            Xn=_ptr(Xn), Ubar=_ptr(Ubar), J=_ptr(J), valid=_ptr(valid), status=_ptr(status),
            B=B, Ps=self.Ps, Fs=self.Fs, Pt=self.Pt, Ft=self.Ft,
            check_bounds=int(bool(check_bounds)), geo=self._geo[1],
        )
        # the struct holds raw pointers: keep what they point to alive
        args._keep = (x0, alpha)
        return args, (Xn, Ubar, J, valid, status), sig, lane_tab

    def search(self, params, al_pad: PaddedAL, Z, K, d, J0, dV1, dV2, alpha, budget) -> dict:
        """Every lane's backtracking line search in one launch, with no host
        sync (csrc/altro_abi.h): from α = `alpha` [B], each lane tries α,
        α/f, α/f², ... (f the options' `line_search_decrease_factor`) until
        a try is accepted (valid, z in the options' bounds, J < J0) or it
        has run `budget` [B] int32 tries, at most the options'
        `line_search_max_iterations`.  The results are those the lockstep
        search (`solver/batched.py:_line_search_sequential`) leaves, bit for
        bit: dict(Xn, Ubar, status of the last try; J, its last valid cost,
        J0 before any; z, its last ratio, -1 before any; alpha, divided once
        more after a last rejection; success [B] bool; tries [B] int32).
        A lane with budget 0 runs no try, and its Xn, Ubar are not
        written.  The tries, the lanes with a budget and the lane tries the
        blocks of LANES lanes ran are added to
        `utils/timer.py:search_counts`; a launch is one `launches`."""
        if self._use_plain(Z.X):
            return self.plain_search(params, al_pad, Z, K, d, J0, dV1, dV2, alpha, budget)
        B = Z.X.shape[-1]
        J0, dV1, dV2 = (v.contiguous() for v in (J0, dV1, dV2))
        for name, v in (("J0", J0), ("dV1", dV1), ("dV2", dV2)):
            self._check(name, v, (B,))
        if budget.dtype != torch.int32 or tuple(budget.shape) != (B,) or budget.device != Z.X.device:
            raise ValueError(f"budget must be int32 [{B}] on {Z.X.device}")
        budget = budget.contiguous()
        o = self.opts
        args, (Xn, Ubar, J, valid, status), sig, lane_tab = self._rollout_args(
            params, al_pad, Z, K, d, alpha, o.check_forwardpass_bounds)
        z, alpha_out = Z.X.new_empty((B,)), Z.X.new_empty((B,))
        success = torch.empty((B,), dtype=torch.int32, device=Z.X.device)
        tries = torch.empty((B,), dtype=torch.int32, device=Z.X.device)
        for name, v in (("J0", J0), ("dV1", dV1), ("dV2", dV2), ("budget", budget), ("alpha_out", alpha_out),
                        ("z", z), ("success", success), ("tries", tries),
                        ("counts", search_counts(Z.X.device))):
            setattr(args, name, _ptr(v))
        args.lower, args.upper = o.line_search_lower_bound, o.line_search_upper_bound
        args.factor = o.line_search_decrease_factor
        args.search = 1
        self._launch(args, sig, lane_tab, Z.X)
        return dict(Xn=Xn, Ubar=Ubar, J=J, z=z, alpha=alpha_out, success=success != 0, status=status, tries=tries)

    def plain_search(self, params, al_pad: PaddedAL, Z, K, d, J0, dV1, dV2, alpha, budget) -> dict:
        """The plain version of `search`: the lockstep search's rounds
        (`solver/batched.py:search_round`) over the lanes that still search,
        until none does.  Its one host read a round, the stop test, is at
        the uncounted site `PLAIN_SEARCH`: it stands in for the kernel,
        which reads nothing."""
        from ..solver.batched import search_round

        ev = self._eager_solver(self.opts.check_forwardpass_bounds)
        c = dict(ev._search_init(Z, J0), alpha=alpha)
        while True:
            active = (~c["success"]) & (c["it"] < budget)
            if not host_read(PLAIN_SEARCH, lambda: bool(active.any())):
                break
            Zbar, valid, status = ev.closed_loop_rollout(params, Z, K, d, alpha=c["alpha"])
            J_try = ev.total_cost(params, al_pad.al, Zbar)
            c = search_round(self.opts, c, active, J0, dV1, dV2, Zbar, valid, status, J_try)
        B = budget.shape[0]
        slowest = torch.nn.functional.pad(c["it"], (0, -B % LANES)).view(-1, LANES).amax(dim=1)
        block = torch.full_like(slowest, LANES)
        block[-1] = B - LANES * (slowest.numel() - 1)
        search_counts(Z.X.device).add_(torch.stack([c["it"].sum(), (budget > 0).sum(), (slowest * block).sum()]))
        return dict(Xn=c["Zbar"].X[1:], Ubar=c["Zbar"].U, J=c["J"], z=c["z"], alpha=c["alpha"],
                    success=c["success"], status=c["status"], tries=c["it"])


def build_forward_kernel(prob, opts, *, dtype=torch.float32, device="cuda"):
    """The forward kernel for `prob`, or None where the problem is one it
    does not take (`Ineligible`): the function form of
    `altro_tpu/ops/forward_pallas.py:build_forward_kernel`, without the
    TPU's interpret mode and tile geometry."""
    try:
        return ForwardKernel(prob, opts, dtype=dtype, device=device)
    except Ineligible:
        return None
