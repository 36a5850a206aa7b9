"""Stand-alone Riccati backward sweep (CUDA, `csrc/riccati.cu`).

Replaces the TPU kernel `altro_tpu/ops/riccati_pallas.py:riccati_pallas`
(body `_kernel`, :111-187), with its contract: the sweep over materialized
expansions `exp` (A [N,n,n,B], B [N,n,m,B], lxx/lxu/luu/lx/lu [N+1,…,B])
and a per-lane regularization ρ [B], returning
`(K [N,m,n,B], d [N,m,B], dV1 [B], dV2 [B], failed [B] bool)`.  A block
owns LANES lanes and runs each lane's sweep on a group of `sweep_group(n)`
threads with the carry in shared memory, the step of
`csrc/sweep_group.cuh` that the fused backward kernel runs too, while a
copy warp stages the next chunk of knots' expansions in shared memory.
Bytes bound it on the H100 (the source note in `csrc/riccati.cu` gives the
counts).  `geometry` chooses the launch, once per (n, m, dtype); the
kernel checks the shared-memory layout it is given against its own.
Unlike the TPU kernel it takes any batch width: the last block masks its
ragged edge.

The kernel is instantiated for float32 and float64 at the (n, m) of the
port's models (`_build.RICCATI_SHAPES`); any other shape or type raises
`Ineligible` when the wrapper is built, and the solver then runs the eager
`riccati_scan`.  Beside the kernel: its plain PyTorch version
(`riccati_plain`, the same recursion with `riccati_pallas`'s NaN-safe pivot
test), which the wrapper runs only for CPU tensors, and a launch counter.
For CUDA tensors the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from ..solver.batched import chol_solve_mat, chol_solve_vec, dotv, mm, mT, mv
from . import _build
from .backward_fused import (
    _SUFFIX, LANES, STAGE_WORDS, Geometry, Ineligible, _align16, _ptr, chunk_knots, sweep_group,
    sweep_scratch,
)

__all__ = ["Ineligible", "RiccatiKernel", "riccati_cuda", "riccati_plain"]

SMEM_SM = 233_472  # shared memory of one H100 multiprocessor, bytes; 1,024 of it kept per block
COPY_THREADS = 32  # the copy warp


def blocks_per_sm(n: int) -> int:
    """Blocks a multiprocessor must hold by shared memory: four where the
    sweep's groups have at most 8 threads, so that B=4096 (512 blocks) runs
    in one wave on the 132; two at n=13, whose 160-thread blocks take 168
    registers a thread or more, so that two fill the register file whatever
    the shared memory (csrc/riccati.cu:ric_min_blocks)."""
    return 2 if sweep_group(n) == 16 else 4

_EXP_KEYS = ("A", "B", "lxx", "lxu", "luu", "lx", "lu")


def staged_entries(n: int, m: int) -> int:
    """Values of one knot that the kernel stages per lane: A, B, lxx, lxu,
    luu, lx, lu."""
    return 2 * n * n + 2 * n * m + m * m + n + m


def riccati_smem(n: int, m: int, itemsize: int, lanes: int, knots: int) -> int:
    """Bytes of csrc/riccati.cu:RicLayout: two buffers of one run per
    16-byte vector of lanes (knots × entries × lanes of the vector; a run
    rounded up to 128 bytes plus 64, so that runs start in other banks),
    then the sweep's per-lane scratch."""
    vec = 16 // itemsize
    run = -(-knots * staged_entries(n, m) * 16 // 128) * 128 + 64
    return 2 * (lanes // vec) * run + _align16(lanes * sweep_scratch(n, m) * itemsize)


def chol_nan_safe(M, diag_add):
    """Unrolled Cholesky of M [m,m,B] + diag_add [B] on the diagonal, as
    `riccati_pallas._chol`: a pivot that is not > 0 (NaN included) flags
    the lane, and is floored at 1e-30 so the lane's numbers stay finite.
    Returns (lower-triangular entries [i][j] as [B] tensors, failed [B])."""
    m = M.shape[0]
    cols = [[None] * m for _ in range(m)]
    failed = torch.zeros(M.shape[-1:], dtype=torch.bool, device=M.device)
    floor = M.new_tensor(1e-30)
    for j in range(m):
        s = M[j, j] + diag_add
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        failed = failed | ~(s > 0.0)
        dj = torch.sqrt(torch.maximum(s, floor))
        cols[j][j] = dj
        inv = 1.0 / dj
        for i in range(j + 1, m):
            s = M[i, j]
            for k in range(j):
                s = s - cols[i][k] * cols[j][k]
            cols[i][j] = s * inv
    return cols, failed


def riccati_plain(exp, rho, gain_limit: float = 1e8):
    """The plain PyTorch version of the kernel: `riccati_pallas._kernel`'s
    recursion (Q terms, NaN-safe Cholesky, gain guard, P update reusing
    (Qxu K)ᵀ, ΔV frozen at a lane's first failure), batch-last."""
    A_all, B_all = exp["A"], exp["B"]
    N, n = A_all.shape[0], A_all.shape[1]
    m, Bsz = B_all.shape[2], A_all.shape[-1]
    P, p = exp["lxx"][N], exp["lx"][N]
    dV1 = A_all.new_zeros((Bsz,))
    dV2 = A_all.new_zeros((Bsz,))
    failed = torch.zeros((Bsz,), dtype=torch.bool, device=A_all.device)
    K_out = A_all.new_empty((N, m, n, Bsz))
    d_out = A_all.new_empty((N, m, Bsz))
    for k in reversed(range(N)):
        A, Bd = A_all[k], B_all[k]
        AtP = mm(mT(A), P)
        Qxx = exp["lxx"][k] + mm(AtP, A)
        Qxu = exp["lxu"][k] + mm(AtP, Bd)
        Quu = exp["luu"][k] + mm(mT(Bd), mm(P, Bd))
        Qx = exp["lx"][k] + mv(mT(A), p)
        Qu = exp["lu"][k] + mv(mT(Bd), p)
        L, fail_k = chol_nan_safe(Quu, rho)
        K = -chol_solve_mat(L, mT(Qxu))
        d = -chol_solve_vec(L, Qu)
        fail_k = fail_k | ~(K.abs().amax(dim=(0, 1)) <= gain_limit) | ~(
            d.abs().amax(dim=0) <= gain_limit
        )
        KtQuu = mm(mT(K), Quu)
        p_new = Qx + mv(KtQuu, d) + mv(mT(K), Qu) + mv(Qxu, d)
        QK = mm(Qxu, K)
        P_new = Qxx + mm(KtQuu, K) + mT(QK) + QK
        failed = failed | fail_k
        keep = ~failed
        P = torch.where(keep, P_new, P)
        p = torch.where(keep, p_new, p)
        dV1 = torch.where(keep, dV1 + dotv(d, Qu), dV1)
        dV2 = torch.where(keep, dV2 + 0.5 * dotv(d, mv(Quu, d)), dV2)
        K_out[k] = K
        d_out[k] = d
    return K_out, d_out, dV1, dV2, failed


class RiccatiKernel:
    """`__call__(exp, rho)` returns `(K, d, dV1, dV2, failed)` as
    `riccati_pallas` does, for expansions of state dimension n and control
    dimension m in `dtype`."""

    def __init__(self, n: int, m: int, *, gain_limit: float = 1e8, dtype=torch.float32):
        if dtype not in _SUFFIX:
            raise Ineligible(f"no Riccati kernel for dtype {dtype}")
        if (n, m) not in _build.RICCATI_SHAPES:
            raise Ineligible(f"no Riccati kernel instantiated for n={n}, m={m}")
        self.n, self.m = n, m
        self.gain_limit = float(gain_limit)
        self.dtype = dtype
        self.entry = f"altro_riccati_n{n}m{m}_{_SUFFIX[dtype]}"
        self._geo = self._layout(torch.finfo(dtype).bits // 8)
        self._geo_abi = self._geo.abi()
        # launches of the CUDA kernel (never of the plain version)
        self.launches = 0

    def _layout(self, itemsize: int) -> Geometry:
        """Blocks of LANES lanes, a group of `sweep_group(n)` threads per
        lane and the copy warp; knots per chunk with at most STAGE_WORDS
        staged values and `blocks_per_sm(n)` blocks' shared memory on one
        multiprocessor."""
        n, m = self.n, self.m
        g = sweep_group(n)

        def smem(knots):
            return riccati_smem(n, m, itemsize, LANES, knots)

        limit = SMEM_SM // blocks_per_sm(n) - 1024
        knots = chunk_knots(LANES * staged_entries(n, m), STAGE_WORDS, smem, limit)
        return Geometry(
            lanes=LANES, knots=knots, group=g, threads=LANES * g + COPY_THREADS, smem=smem(knots),
            tab_smem=0,
        )

    def geometry(self, B: int) -> Geometry:
        """The launch geometry at batch width B."""
        return dataclasses.replace(self._geo, blocks=-(-B // self._geo.lanes))

    def plain(self, exp, rho):
        """The plain PyTorch version of the kernel."""
        return riccati_plain(exp, rho, self.gain_limit)

    def _shapes(self, N: int, B: int) -> dict:
        n, m = self.n, self.m
        return dict(
            A=(N, n, n, B), B=(N, n, m, B), lxx=(N + 1, n, n, B), lxu=(N + 1, n, m, B),
            luu=(N + 1, m, m, B), lx=(N + 1, n, B), lu=(N + 1, m, B), rho=(B,),
        )

    def __call__(self, exp, rho):
        dev = exp["A"].device
        if dev.type == "cpu":
            return self.plain(exp, rho)
        if dev.type != "cuda":
            raise ValueError(f"no kernel or plain version for device {dev}")
        N, B = exp["A"].shape[0], exp["A"].shape[-1]
        ins = {key: exp[key].contiguous() for key in _EXP_KEYS}
        ins["rho"] = rho.contiguous()
        for key, shape in self._shapes(N, B).items():
            t = ins[key]
            if t.device != dev or t.dtype != self.dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"{key}: {tuple(t.shape)} {t.dtype} on {t.device}; the kernel takes "
                    f"{shape} {self.dtype} on {dev}"
                )
        lib = _build.load()
        new = ins["A"].new_empty
        K, d = new((N, self.m, self.n, B)), new((N, self.m, B))
        dV1, dV2 = new((B,)), new((B,))
        failed = torch.empty((B,), dtype=torch.int32, device=dev)
        args = _build.RiccatiArgs(
            A=_ptr(ins["A"]), Bd=_ptr(ins["B"]), lxx=_ptr(ins["lxx"]), lxu=_ptr(ins["lxu"]),
            luu=_ptr(ins["luu"]), lx=_ptr(ins["lx"]), lu=_ptr(ins["lu"]), rho=_ptr(ins["rho"]),
            K=_ptr(K), d=_ptr(d), dV1=_ptr(dV1), dV2=_ptr(dV2), failed=_ptr(failed),
            gain_limit=self.gain_limit, N=N, B=B, geo=self._geo_abi,
        )
        with torch.cuda.device(dev):
            lib.launch(self.entry, args, torch.cuda.current_stream(dev).cuda_stream)
        self.launches += 1
        return K, d, dV1, dV2, failed != 0


def riccati_cuda(exp: dict, rho, *, gain_limit: float = 1e8):
    """One sweep of the Riccati kernel over `exp` at ρ [B], with the
    contract of `riccati_scan`: the function form of
    `altro_tpu/ops/riccati_pallas.py:riccati_pallas`.  Each call builds the
    `RiccatiKernel` of the expansions' (n, m) and type; where none is
    instantiated it raises `Ineligible`, with no fallback."""
    A = exp["A"]
    return RiccatiKernel(A.shape[1], exp["B"].shape[2], gain_limit=gain_limit, dtype=A.dtype)(exp, rho)
