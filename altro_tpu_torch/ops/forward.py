"""Fused closed-loop rollout + cost kernel (CUDA, `csrc/forward.cuh`).

Replaces the TPU kernel `altro_tpu/ops/forward_pallas.py:ForwardKernel`
(body `_make_kernel(check_bounds)`, :534-685).  One thread per batch lane
runs a whole line-search try: the feedback control, the stage cost and AL
terms, the RK4 step and the divergence guard at each knot, then the
terminal terms, with the state carry in registers and J Kahan-summed.  With
α = 0 and K = d = 0 (and `check_bounds=False`) it is the open-loop rollout
that starts each inner solve.

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
            check_bounds=int(bool(check_bounds)), chain_only=int(bool(chain_only)),
            geo=self._geo[1],
        )
        self._launch(args, sig, lane_tab, Z.X)
        return Xn, Ubar, J, valid != 0, status


def build_forward_kernel(prob, opts, *, dtype=torch.float32, device="cuda"):
    """The forward kernel for `prob`, or None where the problem is one it
    does not take (`Ineligible`): the function form of
    `altro_tpu/ops/forward_pallas.py:build_forward_kernel`, without the
    TPU's interpret mode and tile geometry."""
    try:
        return ForwardKernel(prob, opts, dtype=dtype, device=device)
    except Ineligible:
        return None
