"""Fused expansion + Riccati backward kernel (CUDA, `csrc/backward_fused.cuh`).

Replaces the TPU kernel `altro_tpu/ops/backward_fused_pallas.py:
BackwardFusedKernel` (body `_make_kernel`, :302-531).  Per lane it sweeps
the horizon backwards, building the cost, AL and RK4 expansions at each
knot instead of reading materialized [N,·,·,B] tensors, and Kahan-sums the
trajectory's AL cost J0 on the way.

What bounds it on the H100 is the dependent chain of each lane's sweep,
not bytes or operations (`csrc/backward_fused.cuh` gives the numbers).  So
a block of LANES lanes splits its threads: producer warps build the next
chunk of knots' expansions in parallel (each Jacobian column one tangent
of the RK4 step, `step_jacobian_by_tangents` below is that arithmetic in
torch) while consumer warps run the sweep over the chunk before, a group
of threads per lane (one per row of the carry, which lives in shared
memory).  `geometry` chooses the launch (`Geometry`,
`csrc/altro_abi.h:AltroGeometry`) so that B >= 2048 fills the card's 132
multiprocessors; the kernel checks the shared-memory layout it is given
against its own.

The kernel is specialised at build time to the model (a device functor
named by the model's `cuda_model`), the scalar type and n, m; quadratic
costs and goal / control-bound / circle constraints arrive as
batch-shared scalars in a problem descriptor.  Any other structure raises
`Ineligible` when the wrapper is built, and the solver then runs the eager
passes — a decision made once, from the problem's structure.  Circle rows
are evaluated in compensated arithmetic (`comp_circle`), as the TPU
kernels evaluate them.

Per-instance params (any param leaf with a trailing batch axis,
`solver/batched.py:batch_axes`) are read per lane, as the TPU kernels
stream them (`forward_pallas.py:225-265`, `backward_fused_pallas.py:
74-146`): `param_sig` names them, and a second instantiation of each
kernel per model and scalar type (`_lanes` entry points,
`csrc/altro_abi.h:AltroLanes`) reads each named leaf from a lane table
[rows, B] built on the device (`lane_table`), batch last like X and U,
and every other leaf from the descriptor.  A layout the TPU kernels
refuse raises `Ineligible` from `param_sig`, and `takes` is False for it
and for nothing else; the solver then runs the eager passes for that
solve.  Every lane table that `param_sig` admits leaves a chunk within
the shared memory (the largest the descriptor's limits allow is held in
`tests/test_torch_geometry.py`), so no other layout is routed away.

Beside the kernel: its plain PyTorch version (`plain`, the eager
`expand` + `riccati_scan` + `total_cost` composition, with circle rows
through `comp_circle`), which the wrapper runs only for CPU tensors, and a
launch counter (`launches`).  For CUDA tensors the wrapper launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..problem.constraints import Cone
from ..problem.costs import _quadcost_eval
from ..utils.timer import host_read, span
from . import _build

# models with a device functor in csrc/models.cuh: name -> (n, m, the
# params that AltroProblem.dyn carries, in the functor's order)
CUDA_MODELS = {
    "unicycle": (3, 2, ()),
    "cartpole": (4, 1, ("mass_cart", "mass_pole", "length", "gravity")),
    "quadrotor": (13, 4, ("mass", "J", "gravity", "kf", "km", "arm_length")),
    "triple_integrator2": (6, 2, ()),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# The launch geometry of the kernels on the H100 (csrc/altro_abi.h:
# AltroGeometry).  Blocks of LANES lanes, so that B=2048 launches 256 blocks
# on the card's SMS multiprocessors; the backward kernel adds PRODUCERS
# threads that build the expansions beside the sweep's threads (a group per
# lane, `sweep_group`); the forward kernel has two warps, the lanes'
# rollouts and their cost terms with the input staging; the Riccati kernel
# (ops/riccati.py) a group per lane and a copy warp.  A pipeline's first
# chunk of knots is not overlapped (the sweep waits for its expansions, the
# rollouts for their staged inputs), so a chunk holds at most
# PRODUCER_ROUNDS rounds of the producers' items, or STAGE_WORDS staged
# values (`chunk_knots`).
SMS = 132
SMEM_MAX = 232_448  # dynamic shared memory one block may use on the H100, bytes
TABLE_SMEM = 16_384  # the largest cost table staged in shared memory, bytes
LANES = 8
PRODUCERS = 128
PRODUCER_ROUNDS = 8
FWD_THREADS = 64
STAGE_WORDS = 8192
MAX_KNOTS = 16


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def sweep_group(n: int) -> int:
    """Threads per lane in the backward sweep, one per row and one more,
    rounded up to a power of two (csrc/sweep_group.cuh:sweep_group_size)."""
    return 4 if n < 4 else 8 if n < 8 else 16


def comp_circle(dx: torch.Tensor, dy: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """r² − dx² − dy² in compensated arithmetic, operation for operation
    the TPU kernels' `_comp_circle` (altro_tpu/ops/forward_pallas.py:
    457-492) and the CUDA kernels' (csrc/lane_algebra.cuh:comp_circle):
    Dekker-split squares (split constant 4097 in both scalar types, as
    there) and error-free differences, the error terms added last.  The
    plain f32 expression's error is ε·O(r²) absolute, which the AL
    penalties (up to 1e8) amplify; this one's is ε·|c|.  Each torch
    operation rounds once, so the rows equal the kernels' bit for bit."""
    split = 4097.0

    def two_sq(a):
        t = a * split
        hi = t - (t - a)
        lo = a - hi
        sq = a * a
        err = ((hi * hi - sq) + 2.0 * hi * lo) + lo * lo
        return sq, err

    def two_diff(a, b):
        s = a - b
        bb = s - a
        err = (a - (s - bb)) - (b + bb)
        return s, err

    r2, r2e = two_sq(r + torch.zeros_like(dx))
    x2, x2e = two_sq(dx)
    y2, y2e = two_sq(dy)
    s1, e1 = two_diff(r2, x2)
    s2, e2 = two_diff(s1, y2)
    return s2 + (((r2e - x2e) - y2e) + e1 + e2)


def circle_rows_on_card(dx: torch.Tensor, dy: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """`comp_circle` of CUDA tensors of one shape and scalar type, by the
    device function the fused kernels run on each circle row
    (csrc/backward_fused.cu:circle_rows_kernel): the probe that holds the
    kernels' rows against `comp_circle`'s bit for bit."""
    if dx.device.type != "cuda" or dx.dtype not in _SUFFIX:
        raise ValueError("circle_rows_on_card takes float32 or float64 CUDA tensors")
    dx, dy, r = (t.contiguous() for t in torch.broadcast_tensors(dx, dy, r))
    out = torch.empty_like(dx)
    with torch.cuda.device(dx.device):
        _build.load().circle_rows(
            _SUFFIX[dx.dtype], dx.data_ptr(), dy.data_ptr(), r.data_ptr(), out.data_ptr(), dx.numel(),
            torch.cuda.current_stream(dx.device).cuda_stream,
        )
    return out


def sweep_scratch(n: int, m: int) -> int:
    """Values of one lane's sweep scratch (csrc/sweep_group.cuh:
    SweepScratch): P, p, PB, Quu, Qu, K, d, QK."""
    return 2 * n * n + n + 2 * n * m + m * m + 2 * m


def _desc_bytes(lane) -> int:
    """The descriptors staged first: AltroProblem, and AltroLanes for the
    lane-params instantiations (`lane` = (knot rows, static rows))."""
    return _align16(ctypes.sizeof(_build.Problem)) + (
        _align16(ctypes.sizeof(_build.Lanes)) if lane is not None else 0)


def backward_smem(n: int, m: int, itemsize: int, lanes: int, knots: int, tab_smem: int,
                  lane=None) -> int:
    """Bytes of csrc/backward_fused.cuh:BwdLayout: descriptor, cost table,
    the chunk's x, u, two expansion buffers (a slot: A, Bd, lx, lu, hx, hu,
    hxy, the J terms), the cooperative sweep's scratch.  With `lane` =
    (knot rows W, static rows S), the lane-params instantiation's: the
    chunk's W lane rows per knot beside x, u, the cost Hessians' sums in
    each slot, and the S static lane rows."""
    W, S = lane or (0, 0)
    hess = n * n + n * m + m * m if lane is not None else 0
    slot = (n * n + n * m + 2 * n + 2 * m + 1 + 2 * _build.MAX_FAMS + hess) | 1
    return (
        _desc_bytes(lane) + _align16(tab_smem * itemsize)
        + _align16(knots * lanes * (n + m + W) * itemsize) + _align16(2 * knots * lanes * slot * itemsize)
        + _align16(lanes * sweep_scratch(n, m) * itemsize) + _align16(S * lanes * itemsize)
    )


def forward_smem(n: int, m: int, itemsize: int, lanes: int, knots: int, tab_smem: int,
                 Ps: int, Fs: int, lane=None) -> int:
    """Bytes of csrc/forward.cuh:FwdLayout: descriptor, cost table, two
    stages of knots × (x, u, K, d, λ, ρ rows) × lanes, two trails of knots
    × (x, ū) × lanes and x_N.  With `lane` = (knot rows W, static rows S),
    the lane-params instantiation's: W lane rows more per staged knot, and
    knot N's W rows and the S static rows once."""
    W, S = lane or (0, 0)
    rows = n + 2 * m + m * n + Ps + Fs + W
    return (
        _desc_bytes(lane) + _align16(tab_smem * itemsize)
        + _align16(2 * knots * rows * lanes * itemsize)
        + _align16((2 * knots * (n + m) + n) * lanes * itemsize) + _align16((W + S) * lanes * itemsize)
    )


def chunk_knots(per_knot: int, budget: int, smem, limit: int = SMEM_MAX) -> int:
    """Knots per pipeline chunk: the largest power of two up to MAX_KNOTS
    whose chunk holds at most `budget` items, `per_knot` to a knot, and
    whose block's `smem(knots)` bytes fit `limit`."""
    knots = MAX_KNOTS
    while knots > 1 and (knots * per_knot > budget or smem(knots) > limit):
        knots //= 2
    return knots


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch's geometry: `blocks` blocks of `threads` threads, each
    owning `lanes` batch lanes, pipelined over chunks of `knots` knots, with
    `smem` bytes of dynamic shared memory, of which the cost table's first
    `tab_smem` entries (all of it, or 0 when it does not fit)."""

    lanes: int
    knots: int
    group: int
    threads: int
    smem: int
    tab_smem: int
    blocks: int = 0

    def abi(self) -> _build.Geometry:
        return _build.Geometry(
            lanes=self.lanes, knots=self.knots, group=self.group, threads=self.threads,
            smem=self.smem, tab_smem=self.tab_smem,
        )


def step_jacobian_by_tangents(model, x, u, t, h) -> tuple[torch.Tensor, torch.Tensor]:
    """(A [n,n], Bd [n,m]) of one instance's discrete step (x [n], u [m]),
    column by column as the fused backward kernel builds them
    (csrc/fused_common.cuh:dyn_tangent): column j is the tangent of the
    whole step along e_j of (x, u), `torch.func.jvp` of `model`'s step."""
    n, m = x.shape[0], u.shape[0]
    cols = []
    for j in range(n + m):
        e = torch.zeros(n + m, dtype=x.dtype, device=x.device)
        e[j] = 1.0
        cols.append(torch.func.jvp(lambda xx, uu: model(xx, uu, t, h), (x, u), (e[:n], e[n:]))[1])
    AB = torch.stack(cols, dim=1)
    return AB[:, :n], AB[:, n:]


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


# param keys of each constraint structure (forward_pallas.py:_STRUCT_KEYS),
# in the order of AltroLanes.con's sources a, b, r
_STRUCT_KEYS = {"goal": ("xf",), "control_bound": ("lb", "ub"), "circle": ("cx", "cy", "r")}
_COST_LEAVES = ("Q", "R", "H", "q", "r", "c")


def _ndim(leaf) -> int:
    return torch.as_tensor(leaf).ndim


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class LaneLayout:
    """Where the per-lane leaves of one signature sit in the lane table
    [(N+1)·knot_rows + static_rows, B]: the per-knot leaves (stacked cost
    params, per knot and per lane) take knot_rows rows per knot, knot k's
    from row k·knot_rows on; the others take static_rows rows after them.
    `leaves`: name -> (row of its entry 0, within a knot's rows or the
    static rows, per-knot?, entries)."""

    knot_rows: int
    static_rows: int
    leaves: dict

    @property
    def words(self) -> tuple[int, int]:
        return self.knot_rows, self.static_rows


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
    """Eligibility, problem descriptor, AL packing and launch geometry
    shared by the fused backward and forward kernels."""

    KIND = ""  # the kernel's entry-point prefix: "backward_fused" or "forward"

    def __init__(self, prob, opts, *, dtype=torch.float32, device="cuda"):
        self.prob = prob
        self.opts = opts
        self.dtype = dtype
        self.device = torch.device(device)
        N, n, m = prob.N, prob.n, prob.m
        self.N, self.n, self.m = N, n, m
        if dtype not in _SUFFIX:
            raise Ineligible(f"no kernel for dtype {dtype}")
        if len(prob.dynamics_families) != 1:
            raise Ineligible("multiple dynamics families")
        if not prob.dynamics_families[0].shared:
            raise Ineligible("per-knot dynamics params")
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
        pairs = set()
        for fi, fam in enumerate(prob.constraint_families):
            con = fam.constraint
            if fam.cone not in (Cone.ZERO, Cone.NEGATIVE_ORTHANT):  # the SOC, the identity
                raise Ineligible("unsupported cone for the fused kernels")
            if con is None or con.structure is None:
                raise Ineligible("opaque constraint fn")
            kind = con.structure[0]
            if kind not in ("goal", "control_bound", "circle"):
                raise Ineligible(f"constraint structure {kind!r} not in the kernels")
            if kind == "goal" and fam.dim != n:
                raise Ineligible("goal constraint of the wrong dimension")
            if kind == "circle":
                _, xi, yi = con.structure
                if not (0 <= xi < n and 0 <= yi < n and xi != yi) or fam.dim > _build.NMAX:
                    raise Ineligible("circle constraint the descriptor cannot hold")
                pairs.add((xi, yi))
            if not fam.shared:
                raise Ineligible("per-knot constraint params")
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
        # one off-diagonal Gauss-Newton word per knot (csrc/backward_fused.cuh)
        if len(pairs) > 1:
            raise Ineligible("circle families on different coordinate pairs")
        # `_shared_runs` may split a cost family in two
        if 2 * len(self._cost_fams) > _build.MAX_FAMS or len(self._con_fams) > _build.MAX_FAMS:
            raise Ineligible("more families than the descriptor holds")
        self.Ps, self.Fs, self.Pt, self.Ft = Ps, Fs, Pt, Ft
        self._itemsize = torch.finfo(dtype).bits // 8
        # the streamable params (forward_pallas.py:_param_info): name ->
        # (canonical shape, stacked); a stacked cost leaf may be per lane
        # only when its family covers every knot (`_stacked_full`)
        self._param_info = {
            name: (tuple(torch.as_tensor(canon).shape), stacked)
            for name, canon, stacked, _ in self._iter_params(prob.params)
        }
        self._stacked_full = {
            f"cost{f['fi']}_{p}": f["k0"] == 0 and f["k1"] == N
            for f in self._cost_fams if f["stacked"] for p in _COST_LEAVES
        }
        # launches of the CUDA kernel (never of the plain version)
        self.launches = 0
        self._desc_key = None
        # (problem descriptor, cost table) on the device, the lanes
        # descriptor on the host and on the device (None without per-lane
        # leaves), and their launch geometry (`blocks` aside) and its ABI struct
        self._desc = None
        self._lanes = None
        self._geo = None
        # `_prepare`'s last two params objects and what it returned for each
        # (a solve's own and, in the speculative line search, its widened ones)
        self._prep = []
        self._layouts = {}  # signature -> LaneLayout
        self._eager = {}

    # ------------------------------------------------- per-instance params
    def _iter_params(self, params):
        """(name, canonical leaf, stacked, leaf) of every param the kernels
        read, in the TPU kernels' order and names (`forward_pallas.py:
        _iter_params`): the dynamics leaves as JAX flattens them (dict keys
        sorted), then each cost family's Q, R, H, q, r, c, then each
        constraint family's structure keys."""
        canon = self.prob.params

        def dyn_leaves(tree):
            return [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else (
                [] if tree is None else [tree])

        dc, da = dyn_leaves(canon.dynamics[0]), dyn_leaves(params.dynamics[0])
        for i, (c, a) in enumerate(zip(dc, da)):
            yield f"dyn{i}", c, False, a
        for f in self._cost_fams:
            fi = f["fi"]
            for key in _COST_LEAVES:
                yield f"cost{fi}_{key}", canon.costs[fi][key], f["stacked"], params.costs[fi][key]
        for f in self._con_fams:
            fi = f["fi"]
            for key in _STRUCT_KEYS[f["structure"][0]]:
                yield f"con{fi}_{key}", canon.constraints[fi][key], False, params.constraints[fi][key]

    def param_sig(self, params) -> frozenset:
        """The names of the param leaves of `params` that carry a trailing
        batch axis, as the TPU kernels name them (`forward_pallas.py:
        param_sig`).  Raises Ineligible where they do: per-knot and
        per-instance cost params on a partial knot range, or a rank that
        is neither the canonical one nor one more."""
        sig = set()
        for name, canon, stacked, leaf in self._iter_params(params):
            nd_c, nd_a = _ndim(canon), _ndim(leaf)
            if nd_a == nd_c + 1:
                if stacked and not self._stacked_full.get(name, False):
                    raise Ineligible("per-knot AND per-instance cost params on a partial knot range")
                sig.add(name)
            elif nd_a != nd_c:
                raise Ineligible(f"unexpected rank for param {name!r}")
        return frozenset(sig)

    def takes(self, params) -> bool:
        """Whether the kernel takes the per-instance leaves of `params`
        (the solver's per-solve routing, `forward_pallas.py`'s `_use_fwd`):
        False exactly for the layouts `param_sig` refuses."""
        try:
            self.param_sig(params)
        except Ineligible:
            return False
        return True

    def _lane_layout(self, sig: frozenset) -> LaneLayout:
        """The lane table's layout for a signature (cached)."""
        lay = self._layouts.get(sig)
        if lay is None:
            knot, static = {}, {}
            W = S = 0
            for name, (shape, stacked) in self._param_info.items():
                if name not in sig:
                    continue
                if stacked:
                    size = _numel(shape[1:])
                    knot[name] = (W, True, size)
                    W += size
                else:
                    size = _numel(shape)
                    static[name] = (S, False, size)
                    S += size
            lay = LaneLayout(W, S, {**knot, **static})
            self._layouts[sig] = lay
        return lay

    def lane_table(self, params, sig: frozenset, B: int) -> torch.Tensor:
        """The per-lane leaves of `params` as the lane table
        [(N+1)·W + S, B] in the kernel's scalar type (`LaneLayout`), built
        on the device by tensor operations: no value passes through the
        host."""
        lay = self._lane_layout(sig)
        N = self.N
        knot, static = [], []
        for name, canon, stacked, leaf in self._iter_params(params):
            if name not in sig:
                continue
            shape = tuple(torch.as_tensor(canon).shape)
            if tuple(leaf.shape) != shape + (B,):
                raise ValueError(f"per-instance param {name!r} has shape {tuple(leaf.shape)}; "
                                 f"expected {shape + (B,)}")
            if leaf.device != self.device:
                raise ValueError(f"per-instance param {name!r} lies on {leaf.device}")
            leaf = leaf.to(self.dtype)
            if stacked:
                knot.append(leaf.reshape(N + 1, -1, B))
            else:
                static.append(leaf.reshape(-1, B))
        parts = []
        if knot:
            parts.append(torch.cat(knot, dim=1).reshape((N + 1) * lay.knot_rows, B))
        parts.extend(static)
        return torch.cat(parts, dim=0).contiguous()

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
    def _shared_runs(self, k0, k1, stacked, rows):
        """A cost family (knots k0..k1, its rows [knots or 1, row]) as the
        kernels' families: a stacked family whose rows are all equal becomes
        one shared row, and one whose stage rows are equal and end at the
        terminal knot becomes two shared families, the stage knots and the
        terminal knot (the usual stage + terminal LQR cost, grouped into one
        family because both use the same function).  Either way the kernels
        add the same terms to J in the same order: the terminal-only family
        is skipped at the stage knots and the stage family at the terminal
        knot, as the one family was.  The rows hold zeros for the leaves
        read per lane, so the fold is decided on the shared leaves alone;
        the per-lane rows of a family (which covers every knot) are read
        at the absolute knot in both of its parts."""
        if stacked and bool((rows == rows[:1]).all()):
            return [(k0, k1, False, rows[:1])]
        N = self.N
        if stacked and k1 == N and k0 <= N - 1 and bool((rows[:-1] == rows[:1]).all()):
            return [(k0, N - 1, False, rows[:1]), (N, N, False, rows[-1:])]
        return [(k0, k1, stacked, rows)]

    def _problem_desc(self, params, sig: frozenset = frozenset()):
        """The problem's batch-shared params on the device:
        `csrc/altro_abi.h:AltroProblem` as bytes and the cost table in the
        kernel's scalar type (one row per knot of a stacked cost family,
        one per shared family; see `_shared_runs`).  For a non-empty
        signature it sets `_lanes`, `AltroLanes` (on the host, and as bytes
        on the device): where each per-lane leaf sits in the lane table;
        the descriptor holds zeros in their place.  Beside
        them it sets `_geo`, the launch geometry for that table, which is
        staged in shared memory when it holds at most TABLE_SMEM bytes.
        Rebuilt only when `params` carries other shared cost, constraint or
        dynamics leaves, or another signature, than the last call: a tail
        round's gathered per-lane leaves leave it as it was."""
        shared = tuple(leaf for name, _, _, leaf in self._iter_params(params) if name not in sig)
        cached = self._desc_key
        if cached is not None and cached[0] == sig and len(shared) == len(cached[1]) and all(
                a is b for a, b in zip(shared, cached[1])):
            return self._desc
        n, m = self.n, self.m
        o = self.opts
        lay = self._lane_layout(sig) if sig else None
        d = _build.Problem()
        d.N, d.method = self.N, self.method
        d.n_con = len(self._con_fams)
        d.gain_limit = float(o.bp_gain_limit)
        d.state_max2 = float(o.state_max) ** 2
        d.control_max2 = float(o.control_max) ** 2
        ln = _build.Lanes()
        if lay is not None:
            ln.knot_rows, ln.static_rows = lay.knot_rows, lay.static_rows
            for src in (*ln.dyn, *(x for row in ln.cost for x in row), *(x for row in ln.con for x in row)):
                src.off = -1

        def host(name, t, size):
            """A shared leaf on the host in float64 (a `kernel_prep` host read
            where it is a tensor), or zeros for a per-lane one."""
            if name in sig:
                return torch.zeros(size, dtype=torch.float64)
            if torch.is_tensor(t):
                a = host_read("kernel_prep", lambda: t.detach().to("cpu", torch.float64))
            else:
                a = torch.as_tensor(t, dtype=torch.float64)
            if a.numel() != size:
                raise ValueError(f"param {name!r} of {a.numel()} entries where {size} were expected")
            return a

        def src(dst, name, entry=0):
            """Point a lane source at leaf `name`'s entry `entry`."""
            if name in sig:
                row, per_knot, _ = lay.leaves[name]
                dst.off, dst.kstride = row + entry, lay.knot_rows if per_knot else 0

        if self._dyn_names:
            names = sorted(self._dyn_names)  # dyn{i} follows JAX's (sorted) leaf order
            parts = []
            for key in self._dyn_names:
                name = f"dyn{names.index(key)}"
                size = _numel(self._param_info[name][0])
                first = sum(p.numel() for p in parts)
                parts.append(host(name, params.dynamics[0][key], size).reshape(-1))
                for e in range(size):
                    if first + e < _build.NDYN:
                        src(ln.dyn[first + e], name, e)
            dyn = torch.cat(parts)
            if dyn.numel() > _build.NDYN:
                raise ValueError(f"{dyn.numel()} dynamics params; the descriptor holds {_build.NDYN}")
            d.dyn[: dyn.numel()] = dyn.tolist()

        fams = []
        for f in self._cost_fams:
            fi, cp = f["fi"], params.costs[f["fi"]]
            nk = f["k1"] - f["k0"] + 1 if f["stacked"] else 1
            parts = [
                host(f"cost{fi}_{name}", cp[name], nk * size).reshape(nk, size)
                for name, size in (("Q", n * n), ("R", m * m), ("H", n * m), ("q", n), ("r", m), ("c", 1))
            ]
            fams.extend((run, fi) for run in self._shared_runs(f["k0"], f["k1"], f["stacked"], torch.cat(parts, dim=1)))
        d.n_cost = len(fams)
        offset = 0
        for j, (c, ((k0, k1, stacked, rows), fi)) in enumerate(zip(d.cost, fams)):
            c.k0, c.k1, c.stacked, c.offset = k0, k1, int(stacked), offset
            offset += rows.numel()
            for leaf, key in enumerate(_COST_LEAVES):
                src(ln.cost[j][leaf], f"cost{fi}_{key}")
        for i, f in enumerate(self._con_fams):
            fi, cp = f["fi"], params.constraints[f["fi"]]
            c = d.con[i]
            c.cone = (
                _build.CONE_ZERO if f["cone"] is Cone.ZERO else _build.CONE_NEGATIVE_ORTHANT
            )
            c.k0, c.k1, c.p = f["k0"], f["k1"], f["p"]
            c.stage_row, c.stage_fam = f["stage_row"], f["stage_fam"]
            c.term_row, c.term_fam = f["term_row"], f["term_fam"]
            kind = f["structure"][0]
            for j, key in enumerate(_STRUCT_KEYS[kind]):
                src(ln.con[i][j], f"con{fi}_{key}")
            if kind == "goal":
                c.kind = _build.GOAL
                c.a[:n] = host(f"con{fi}_xf", cp["xf"], n).tolist()
            elif kind == "circle":
                p = f["p"]
                c.kind = _build.CIRCLE
                _, c.xi, c.yi = f["structure"]
                c.a[:p] = host(f"con{fi}_cx", cp["cx"], p).tolist()
                c.b[:p] = host(f"con{fi}_cy", cp["cy"], p).tolist()
                c.r[:p] = host(f"con{fi}_r", cp["r"], p).tolist()
            else:
                _, lo_idx, hi_idx = f["structure"]
                c.kind = _build.CONTROL_BOUND
                c.lo_mask = sum(1 << j for j in lo_idx)
                c.hi_mask = sum(1 << j for j in hi_idx)
                c.a[:m] = host(f"con{fi}_lb", cp["lb"], m).tolist()
                c.b[:m] = host(f"con{fi}_ub", cp["ub"], m).tolist()

        def upload(t):
            """A host tensor on the device: a copy that waits for the
            device's queue (a `kernel_prep` host read)."""
            return host_read("kernel_prep", lambda: t.to(self.device))

        def dev_bytes(struct):
            return upload(torch.frombuffer(bytearray(bytes(struct)), dtype=torch.uint8))

        table = torch.cat([run[3].reshape(-1) for run, _ in fams]) if fams else torch.zeros(1, dtype=torch.float64)
        tab = table.numel() if table.numel() * self._itemsize <= TABLE_SMEM else 0
        geo = self._layout(tab, lay.words if lay is not None else None)
        self._geo = (geo, geo.abi())
        self._desc = (dev_bytes(d), upload(table.to(self.dtype)))
        self._lanes = (ln, dev_bytes(ln)) if lay is not None else None
        self._desc_key = (sig, shared)
        self._prep = []
        return self._desc

    # ------------------------------------------------------------ launching
    def _eager_solver(self, check_bounds: bool = True):
        """The eager solver whose passes are the plain versions; it
        evaluates circle rows as the kernels do (`comp_circle`)."""
        if check_bounds not in self._eager:
            from ..solver.batched import ALSolverBatched

            self._eager[check_bounds] = ALSolverBatched(
                self.prob,
                self.opts.replace(
                    backward_pass="scan", forward_pass="scan",
                    check_forwardpass_bounds=check_bounds,
                ),
                compensated_circles=True,
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

    def geometry(self, B: int, params=None) -> Geometry:
        """The launch geometry at batch width B for `params` (the problem's
        own when None)."""
        params = self.prob.params if params is None else params
        self._problem_desc(params, self.param_sig(params))
        geo = self._geo[0]
        return dataclasses.replace(geo, blocks=-(-B // geo.lanes))

    def _entry(self, sig: frozenset) -> str:
        lanes = "lanes_" if sig else ""
        return f"altro_{self.KIND}_{lanes}{self.model_name}_{_SUFFIX[self.dtype]}"

    def _prepare(self, params, B: int):
        """(signature, cost table, lane table or None) of `params`, with the
        descriptor and the geometry built for them.  The last two params
        objects' are kept: the launches of one solve all get the same params
        (and the speculative line search's launches the same widened ones)
        and prepare nothing again, and a new params object (a tail or
        restart round's gathered leaves) gets its own lane table.  A miss
        is the tracer's span `kernel.prepare`."""
        entry = next((e for e in self._prep if e[0] is params), None)
        if entry is None:
            with span("kernel.prepare"):
                sig = self.param_sig(params)
                _, table = self._problem_desc(params, sig)
                entry = (params, sig, table, self.lane_table(params, sig, B) if sig else None)
                self._prep = (self._prep + [entry])[-2:]
        _, sig, table, lane_tab = entry
        if lane_tab is not None and lane_tab.shape[1] != B:
            raise ValueError(f"per-instance params of batch {lane_tab.shape[1]} for a launch of batch {B}")
        return sig, table, lane_tab

    def _launch(self, args, sig: frozenset, lane_tab, like: torch.Tensor) -> None:
        """Launch the kernel with its args struct: the shared-param entry
        point for an empty signature, else the lane-params one with the
        lanes descriptor and the lane table."""
        lib = _build.load()
        ptrs = [self._desc[0].data_ptr()]
        if sig:
            ln, ln_dev = self._lanes
            ptrs += [ctypes.addressof(ln), ln_dev.data_ptr(), lane_tab.data_ptr()]
        with torch.cuda.device(like.device):
            lib.launch(self._entry(sig), args, *ptrs, self._stream(like))
        self.launches += 1

    @staticmethod
    def _stream(t: torch.Tensor) -> int:
        return torch.cuda.current_stream(t.device).cuda_stream


class BackwardFusedKernel(FusedKernel):
    """`__call__(params, al_pad, Z, rho)` returns
    `(K [N,m,n,B], d [N,m,B], dV1 [B], dV2 [B], failed [B] bool, J0 [B])`,
    equal to `expand` + `riccati_scan` + `total_cost` (circle rows through
    `comp_circle`) up to rounding."""

    KIND = "backward_fused"

    def _chunk_knots(self, lane=None) -> int:
        """Knots per chunk: PRODUCER_ROUNDS rounds of the producers, an item
        being one column of [A Bd] or the cost and AL terms of a knot and
        lane."""
        n, m = self.n, self.m
        return chunk_knots(
            LANES * (n + m + 1), PRODUCER_ROUNDS * PRODUCERS,
            lambda knots: backward_smem(n, m, self._itemsize, LANES, knots, TABLE_SMEM // self._itemsize, lane),
        )

    def _layout(self, tab: int, lane=None) -> Geometry:
        """Consumer warps (a group of `sweep_group(n)` threads per lane) and
        PRODUCERS producer threads, with `tab` cost-table entries staged and
        `lane` = (knot rows, static rows) of a lane table (None: the
        shared-param instantiation)."""
        n, m, g = self.n, self.m, sweep_group(self.n)
        knots = self._chunk_knots(lane)
        smem = backward_smem(n, m, self._itemsize, LANES, knots, tab, lane)
        if smem > SMEM_MAX:  # beyond every layout `param_sig` admits
            raise ValueError(f"{smem} bytes of shared memory for one chunk of knots")
        return Geometry(
            lanes=LANES, knots=knots, group=g, threads=-(-LANES * g // 32) * 32 + PRODUCERS,
            smem=smem, tab_smem=tab,
        )

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
        sig, table, lane_tab = self._prepare(params, B)
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
            geo=self._geo[1],
        )
        self._launch(args, sig, lane_tab, Z.X)
        return K, d, dV1, dV2, failed != 0, J0



def build_backward_fused_kernel(prob, opts, *, dtype=torch.float32, device="cuda"):
    """The fused backward kernel for `prob`, or None where the problem is
    one it does not take (`Ineligible`): the function form of
    `altro_tpu/ops/backward_fused_pallas.py:build_backward_fused_kernel`,
    without the TPU's interpret mode and tile geometry."""
    try:
        return BackwardFusedKernel(prob, opts, dtype=dtype, device=device)
    except Ineligible:
        return None
