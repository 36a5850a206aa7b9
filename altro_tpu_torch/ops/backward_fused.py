"""Fused expansion + Riccati backward kernel (CUDA, `csrc/backward_fused.cu`).

Replaces the TPU kernel `altro_tpu/ops/backward_fused_pallas.py:
BackwardFusedKernel` (body `_make_kernel`, :302-531).  One thread per batch
lane sweeps the horizon backwards with the cost-to-go carry in registers,
building the cost, AL and RK4 expansions at each knot instead of reading
materialized [N,·,·,B] tensors, and Kahan-sums the trajectory's AL cost J0
on the way.  What bounds it on the H100 is per-lane arithmetic and
registers, not bytes (the source note in `csrc/backward_fused.cu` gives the
numbers); one thread per lane keeps every carry in registers and every load
coalesced, at the price of a grid too small to fill the card at B=4096.

The kernel is specialised at build time to the model (a device functor
named by the model's `cuda_model`), the scalar type and n, m; quadratic
costs and goal / control-bound constraints arrive as batch-shared scalars.
Any other structure raises `Ineligible` when the wrapper is built, and the
solver then runs the eager passes — a decision made once, from the
problem's structure.

Beside the kernel: its plain PyTorch version (`plain`, the eager
`expand` + `riccati_scan` + `total_cost` composition), which the wrapper
runs only for CPU tensors, and a launch counter (`launches`).  For CUDA
tensors the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..problem.constraints import Cone
from ..problem.costs import _quadcost_eval
from . import _build

# models with a device functor in csrc/models.cuh: name -> (n, m, the
# params that AltroProblem.dyn carries, in the functor's order)
CUDA_MODELS = {
    "unicycle": (3, 2, ()),
    "cartpole": (4, 1, ("mass_cart", "mass_pole", "length", "gravity")),
    "quadrotor": (13, 4, ("mass", "J", "gravity", "kf", "km", "arm_length")),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


class Ineligible(Exception):
    """A problem structure, shape or scalar type that a kernel does not take."""


def _contiguous(knots: np.ndarray) -> tuple[int, int]:
    if len(knots) == 0:
        raise Ineligible("empty knot range")
    if len(knots) > 1 and not np.all(np.diff(knots) == 1):
        raise Ineligible("non-contiguous knot range")
    return int(knots[0]), int(knots[-1])


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@dataclasses.dataclass(frozen=True)
class PaddedAL:
    """The AL state of one inner solve packed for the kernels
    (`forward_pallas.py:716` pads it per family; here the families share
    one buffer): stage multipliers lam [N, Ps, B] (zero outside a family's
    knots) and penalties rho [N, Fs, B] (one there), terminal lamT [Pt, B]
    and rhoT [Ft, B].  `al` is the unpadded state it came from, which the
    plain versions read.  Buffers of a problem without such families are
    None."""

    lam: Optional[torch.Tensor]
    rho: Optional[torch.Tensor]
    lamT: Optional[torch.Tensor]
    rhoT: Optional[torch.Tensor]
    al: tuple


class FusedKernel:
    """Eligibility, problem descriptor and AL packing shared by the fused
    backward and forward kernels."""

    def __init__(self, prob, opts, *, dtype=torch.float32, device="cuda"):
        self.prob = prob
        self.opts = opts
        self.dtype = dtype
        self.device = torch.device(device)
        N, n, m = prob.N, prob.n, prob.m
        self.N, self.n, self.m = N, n, m
        if dtype not in _SUFFIX:
            raise Ineligible(f"no kernel for dtype {dtype}")
        if len(prob.dynamics_families) != 1 or not prob.dynamics_families[0].shared:
            raise Ineligible("heterogeneous dynamics")
        model = prob.dynamics_families[0].model
        if model is None or model.method not in ("rk4", "euler"):
            raise Ineligible("unknown integrator")
        if CUDA_MODELS.get(model.cuda_model, (None, None))[:2] != (n, m):
            raise Ineligible(f"no CUDA device functor for model {model.name!r}")
        self.model_name = model.cuda_model
        self._dyn_names = CUDA_MODELS[model.cuda_model][2]
        self.method = 0 if model.method == "rk4" else 1
        if n > _build.NMAX or m > _build.NMAX:
            raise Ineligible("state or control dimension too large for the descriptor")

        self._cost_fams = []
        for fi, fam in enumerate(prob.cost_families):
            if fam.fn is not _quadcost_eval:
                raise Ineligible("non-quadratic cost family")
            k0, k1 = _contiguous(fam.knots)
            self._cost_fams.append(dict(fi=fi, k0=k0, k1=k1, stacked=not fam.shared))

        self._con_fams = []
        Ps = Fs = Pt = Ft = 0
        for fi, fam in enumerate(prob.constraint_families):
            con = fam.constraint
            if con is None or con.structure is None:
                raise Ineligible("opaque constraint fn")
            kind = con.structure[0]
            if kind not in ("goal", "control_bound"):
                raise Ineligible(f"constraint structure {kind!r} not in the kernels")
            if kind == "goal" and fam.dim != n:
                raise Ineligible("goal constraint of the wrong dimension")
            if not fam.shared:
                raise Ineligible("per-knot constraint params")
            if fam.cone not in (Cone.ZERO, Cone.NEGATIVE_ORTHANT):
                raise Ineligible("unsupported cone for the fused kernels")
            k0, k1 = _contiguous(fam.knots)
            f = dict(
                fi=fi, k0=k0, k1=k1, p=fam.dim, cone=fam.cone, structure=con.structure,
                stage_row=-1, stage_fam=-1, term_row=-1, term_fam=-1,
            )
            if k0 <= N - 1:
                f.update(stage_row=Ps, stage_fam=Fs)
                Ps += fam.dim
                Fs += 1
            if k1 == N:
                f.update(term_row=Pt, term_fam=Ft)
                Pt += fam.dim
                Ft += 1
            self._con_fams.append(f)
        if len(self._cost_fams) > _build.MAX_FAMS or len(self._con_fams) > _build.MAX_FAMS:
            raise Ineligible("more families than the descriptor holds")
        self.Ps, self.Fs, self.Pt, self.Ft = Ps, Fs, Pt, Ft
        # launches of the CUDA kernel (never of the plain version)
        self.launches = 0
        self._desc_key = None
        self._desc = None  # (problem descriptor, cost table) on the device
        self._eager = {}

    # ------------------------------------------------------------ AL state
    def pad_al(self, al) -> PaddedAL:
        """Pack the per-family AL state into the kernels' buffers.  Call once
        per inner solve: duals and penalties are constant within it."""
        N = self.N
        if not al:
            return PaddedAL(None, None, None, None, tuple(al))
        B = al[0]["rho"].shape[-1]
        ref = al[0]["rho"]
        lam = ref.new_zeros((N, self.Ps, B)) if self.Ps else None
        rho = ref.new_ones((N, self.Fs, B)) if self.Fs else None
        lamT = ref.new_zeros((self.Pt, B)) if self.Pt else None
        rhoT = ref.new_ones((self.Ft, B)) if self.Ft else None
        for f, st in zip(self._con_fams, al):
            p = f["p"]
            if f["stage_row"] >= 0:
                hi = min(f["k1"], N - 1)
                nk = hi - f["k0"] + 1
                lam[f["k0"]: hi + 1, f["stage_row"]: f["stage_row"] + p] = st["lam"][:nk]
                rho[f["k0"]: hi + 1, f["stage_fam"]] = st["rho"][:nk]
            if f["term_row"] >= 0:
                lamT[f["term_row"]: f["term_row"] + p] = st["lam"][-1]
                rhoT[f["term_fam"]] = st["rho"][-1]
        return PaddedAL(lam, rho, lamT, rhoT, tuple(al))

    # ------------------------------------------------------ problem descriptor
    def _problem_desc(self, params) -> tuple[torch.Tensor, torch.Tensor]:
        """The problem's params on the device: `csrc/altro_abi.h:AltroProblem`
        as bytes, and the cost table in the kernel's scalar type (one row per
        knot of a stacked cost family, one per shared family).  Rebuilt only
        when `params` carries other cost, constraint or dynamics data than
        the last call."""
        key = (params.costs, params.constraints, params.dynamics)
        if self._desc_key is not None and all(a is b for a, b in zip(key, self._desc_key)):
            return self._desc
        n, m = self.n, self.m
        o = self.opts
        d = _build.Problem()
        d.N, d.method = self.N, self.method
        d.n_cost, d.n_con = len(self._cost_fams), len(self._con_fams)
        d.gain_limit = float(o.bp_gain_limit)
        d.state_max2 = float(o.state_max) ** 2
        d.control_max2 = float(o.control_max) ** 2

        def host(t, size=None):
            a = torch.as_tensor(t).detach().to("cpu", torch.float64)
            if size is not None and a.numel() != size:
                raise ValueError(f"param of {a.numel()} entries where {size} were expected")
            return a

        if self._dyn_names:
            dyn = torch.cat([host(params.dynamics[0][name]).reshape(-1) for name in self._dyn_names])
            if dyn.numel() > _build.NDYN:
                raise ValueError(f"{dyn.numel()} dynamics params; the descriptor holds {_build.NDYN}")
            d.dyn[: dyn.numel()] = dyn.tolist()

        rows, offset = [], 0
        for i, f in enumerate(self._cost_fams):
            cp = params.costs[f["fi"]]
            nk = f["k1"] - f["k0"] + 1 if f["stacked"] else 1
            parts = [
                host(cp[name], nk * size).reshape(nk, size)
                for name, size in (("Q", n * n), ("R", m * m), ("H", n * m), ("q", n), ("r", m), ("c", 1))
            ]
            rows.append(torch.cat(parts, dim=1).reshape(-1))
            c = d.cost[i]
            c.k0, c.k1, c.stacked, c.offset = f["k0"], f["k1"], int(f["stacked"]), offset
            offset += rows[-1].numel()
        for i, f in enumerate(self._con_fams):
            cp = params.constraints[f["fi"]]
            c = d.con[i]
            c.cone = (
                _build.CONE_ZERO if f["cone"] is Cone.ZERO else _build.CONE_NEGATIVE_ORTHANT
            )
            c.k0, c.k1, c.p = f["k0"], f["k1"], f["p"]
            c.stage_row, c.stage_fam = f["stage_row"], f["stage_fam"]
            c.term_row, c.term_fam = f["term_row"], f["term_fam"]
            if f["structure"][0] == "goal":
                c.kind = _build.GOAL
                c.a[:n] = host(cp["xf"], n).tolist()
            else:
                _, lo_idx, hi_idx = f["structure"]
                c.kind = _build.CONTROL_BOUND
                c.lo_mask = sum(1 << j for j in lo_idx)
                c.hi_mask = sum(1 << j for j in hi_idx)
                c.a[:m] = host(cp["lb"], m).tolist()
                c.b[:m] = host(cp["ub"], m).tolist()
        raw = torch.frombuffer(bytearray(bytes(d)), dtype=torch.uint8)
        table = torch.cat(rows) if rows else torch.zeros(1, dtype=torch.float64)
        self._desc = (raw.to(self.device), table.to(self.device, self.dtype))
        self._desc_key = key
        return self._desc

    # ------------------------------------------------------------ launching
    def _eager_solver(self, check_bounds: bool = True):
        """The eager solver whose passes are the plain versions."""
        if check_bounds not in self._eager:
            from ..solver.batched import ALSolverBatched

            self._eager[check_bounds] = ALSolverBatched(
                self.prob,
                self.opts.replace(
                    backward_pass="scan", forward_pass="scan",
                    check_forwardpass_bounds=check_bounds,
                ),
            )
        return self._eager[check_bounds]

    def _use_plain(self, t: torch.Tensor) -> bool:
        """True for CPU tensors (plain version); False for CUDA tensors
        (kernel); anything else raises."""
        if t.device.type == "cpu":
            return True
        if t.device.type != "cuda":
            raise ValueError(f"no kernel or plain version for device {t.device}")
        return False

    def _check(self, name: str, t: Optional[torch.Tensor], shape: tuple):
        if t is None:
            return
        dev = self.device
        if t.device.type != "cuda" or dev.type != "cuda" or (
            dev.index is not None and t.device.index != dev.index
        ):
            raise ValueError(f"{name} lies on {t.device}; this kernel was built for {dev}")
        if t.dtype != self.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes {self.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def _check_al(self, al_pad: PaddedAL, B: int) -> None:
        N = self.N
        self._check("lam", al_pad.lam, (N, self.Ps, B))
        self._check("rho", al_pad.rho, (N, self.Fs, B))
        self._check("lamT", al_pad.lamT, (self.Pt, B))
        self._check("rhoT", al_pad.rhoT, (self.Ft, B))

    def _entry(self, kind: str) -> str:
        return f"altro_{kind}_{self.model_name}_{_SUFFIX[self.dtype]}"

    @staticmethod
    def _stream(t: torch.Tensor) -> int:
        return torch.cuda.current_stream(t.device).cuda_stream


class BackwardFusedKernel(FusedKernel):
    """`__call__(params, al_pad, Z, rho)` returns
    `(K [N,m,n,B], d [N,m,B], dV1 [B], dV2 [B], failed [B] bool, J0 [B])`,
    equal to `expand` + `riccati_scan` + `total_cost` up to rounding."""

    def plain(self, params, al_pad: PaddedAL, Z, rho):
        """The plain PyTorch version of the kernel."""
        ev = self._eager_solver()
        exp = ev.expand(params, al_pad.al, Z)
        K, d, dV1, dV2, failed = ev.riccati_scan(exp, rho)
        return K, d, dV1, dV2, failed, ev.total_cost(params, al_pad.al, Z)

    def __call__(self, params, al_pad: PaddedAL, Z, rho):
        if self._use_plain(Z.X):
            return self.plain(params, al_pad, Z, rho)
        N, n, m = self.N, self.n, self.m
        B = Z.X.shape[-1]
        self._check("t", Z.t, (N + 1,))
        self._check("h", Z.h, (N,))
        self._check("X", Z.X, (N + 1, n, B))
        self._check("U", Z.U, (N, m, B))
        self._check("rho", rho, (B,))
        self._check_al(al_pad, B)
        lib = _build.load()
        desc, table = self._problem_desc(params)
        new = Z.X.new_empty
        K, d = new((N, m, n, B)), new((N, m, B))
        dV1, dV2, J0 = new((B,)), new((B,)), new((B,))
        failed = torch.empty((B,), dtype=torch.int32, device=Z.X.device)
        args = _build.BackwardArgs(
            cost_tab=_ptr(table), t=_ptr(Z.t), h=_ptr(Z.h), X=_ptr(Z.X), U=_ptr(Z.U), rho=_ptr(rho),
            lam=_ptr(al_pad.lam), lam_rho=_ptr(al_pad.rho),
            lamT=_ptr(al_pad.lamT), lamT_rho=_ptr(al_pad.rhoT),
            K=_ptr(K), d=_ptr(d), dV1=_ptr(dV1), dV2=_ptr(dV2), J0=_ptr(J0),
            failed=_ptr(failed), B=B, Ps=self.Ps, Fs=self.Fs, Pt=self.Pt, Ft=self.Ft,
        )
        with torch.cuda.device(Z.X.device):
            lib.launch(self._entry("backward_fused"), args, desc.data_ptr(), self._stream(Z.X))
        self.launches += 1
        return K, d, dV1, dV2, failed != 0, J0

