"""The kernels' launch geometry and the fused kernels' problem descriptor,
as the wrappers compute them on the host (no card needed).

For every model with a device functor, both scalar types and both fused
kernels, at B in {1, 1000, 2048, 4096}: the block's dynamic shared memory
fits the H100's 232,448 bytes, B >= 2048 launches at least one block per
multiprocessor (132), every batch lane falls in exactly one block, and the
geometry passes the checks the kernels' launchers make
(`csrc/backward_fused.cu:launch_backward`, `csrc/forward.cu:
launch_forward`).  The descriptor folds the stacked stage + terminal cost
family into two shared families only where the kernels then add the same
J terms in the same order.

For the Riccati kernel, at each instance (3,2), (4,1), (6,2), (13,4) in
both scalar types and B in {1, 1000, 1001, 4096}: blocks of 8 lanes with a
group of `sweep_group(n)` threads per lane in whole warps plus the copy
warp, the knots per chunk, shared memory equal to the layout of
`csrc/riccati.cu:RicLayout` and within the card's limit, and four blocks
per multiprocessor (two at n=13; what `launch_riccati` and the design
require).
"""
import dataclasses
import functools

import pytest
import torch

from altro_tpu_torch import SolverOptions
from altro_tpu_torch.models.problems import UnicycleProblem, zoo_cartpole, zoo_quadrotor
from altro_tpu_torch.ops import _build
from altro_tpu_torch.ops import backward_fused as bf
from altro_tpu_torch.ops.backward_fused import BackwardFusedKernel
from altro_tpu_torch.ops.forward import ForwardKernel
from altro_tpu_torch.ops.riccati import RiccatiKernel

KERNELS = {"backward_fused": BackwardFusedKernel, "forward": ForwardKernel}


@functools.lru_cache(maxsize=None)
def _problem(model, dtype):
    if model == "unicycle":
        return UnicycleProblem(dtype=dtype, device="cpu").make_problem().compile()
    return (zoo_quadrotor if model == "quadrotor" else zoo_cartpole)(dtype=dtype, device="cpu")[0]


@pytest.mark.parametrize("B", [1, 1000, 2048, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model", ["unicycle", "cartpole", "quadrotor"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_launch_geometry(kind, model, dtype, B):
    prob = _problem(model, dtype)
    g = KERNELS[kind](prob, SolverOptions(), dtype=dtype, device="cpu").geometry(B)
    assert g.smem <= bf.SMEM_MAX
    if B >= 2048:
        assert g.blocks >= bf.SMS
    lanes = torch.arange(g.blocks)[:, None] * g.lanes + torch.arange(g.lanes)[None, :]
    assert torch.equal(torch.sort(lanes[lanes < B]).values, torch.arange(B))
    # the kernels' __launch_bounds__: 256 threads, the forward kernel's two warps
    assert g.threads % 32 == 0 and g.threads <= (256 if kind == "backward_fused" else 64)
    assert g.tab_smem * (torch.finfo(dtype).bits // 8) <= bf.TABLE_SMEM
    if kind == "backward_fused":
        consumers = -(-g.lanes * g.group // 32) * 32
        assert g.group > prob.n and 32 % g.group == 0
        assert g.threads - consumers >= 32 and g.lanes * g.group % 32 == 0
    else:
        assert g.threads == 64 and g.lanes <= 32


def _families(kern, params):
    desc = _build.Problem.from_buffer_copy(bytes(kern._problem_desc(params)[0].numpy()))
    return desc, [(f.k0, f.k1, f.stacked, f.offset) for f in desc.cost[: desc.n_cost]]


def _cost_terms(desc, N):
    """The (knot, family) of each cost term the kernels Kahan-add to J, in
    order: the backward kernel's terminal terms, then k = N-1 ... 0, with a
    gated zero (family None) where a family with stage knots is off."""
    out = []
    for k in [N, *range(N - 1, -1, -1)]:
        for f in desc.cost[: desc.n_cost]:
            if k == N:
                if f.k1 == N:
                    out.append((k, "on"))
            elif f.k0 <= N - 1:
                out.append((k, "on" if f.k0 <= k <= min(f.k1, N - 1) else None))
    return out


def test_descriptor_folds_the_stage_and_terminal_cost_rows():
    """The parking problem's one stacked cost family (stage rows equal, a
    terminal row) becomes two shared families over 0..N-1 and N, the table
    two rows, and the kernels add the same cost terms in the same order as
    over the stacked family; a family whose stage rows differ stays
    stacked."""
    prob = _problem("unicycle", torch.float64)
    N = prob.N
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float64, device="cpu")
    desc, fams = _families(kern, prob.params)
    row = 3 * 3 + 2 * 2 + 3 * 2 + 3 + 2 + 1  # Q, R, H, q, r, c of n=3, m=2
    assert fams == [(0, N - 1, 0, 0), (N, N, 0, row)]
    assert kern._problem_desc(prob.params)[1].numel() == 2 * row
    stacked = _build.Problem()
    stacked.N, stacked.n_cost = N, 1
    stacked.cost[0].k0, stacked.cost[0].k1, stacked.cost[0].stacked = 0, N, 1
    assert _cost_terms(desc, N) == _cost_terms(stacked, N)

    costs = list(prob.params.costs)
    Q = costs[0]["Q"].clone()
    Q[3] *= 2.0  # knot 3's stage row differs from the others
    costs[0] = dict(costs[0], Q=Q)
    desc, fams = _families(kern, prob.params.replace(costs=tuple(costs)))
    assert fams == [(0, N, 1, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model", ["unicycle", "quadrotor"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_a_cost_table_larger_than_TABLE_SMEM_stays_in_device_memory(kind, model, dtype):
    """With each knot's Q scaled by its own factor the cost table holds a
    row per knot; the geometry stages it in shared memory only where it fits
    TABLE_SMEM (the unicycle in f32), and its shared memory then counts the
    table, else none of it."""
    prob = _problem(model, dtype)
    kern = KERNELS[kind](prob, SolverOptions(), dtype=dtype, device="cpu")
    costs = list(prob.params.costs)
    Q = costs[0]["Q"]
    costs[0] = dict(costs[0], Q=Q * (1.0 + 1e-3 * torch.arange(Q.shape[0], dtype=dtype))[:, None, None])
    params = prob.params.replace(costs=tuple(costs))
    shared, per_knot = kern.geometry(1000), kern.geometry(1000, params)
    table = kern._problem_desc(params)[1].numel()
    assert table == (prob.N + 1) * (prob.n * prob.n + prob.m * prob.m + prob.n * prob.m + prob.n + prob.m + 1)
    itemsize = torch.finfo(dtype).bits // 8
    staged = model == "unicycle" and dtype == torch.float32
    assert (table * itemsize <= bf.TABLE_SMEM) == staged
    assert per_knot.tab_smem == (table if staged else 0)
    layout = bf._align16(shared.tab_smem * itemsize)
    assert per_knot.smem - shared.smem == (bf._align16(table * itemsize) if staged else 0) - layout
    assert dataclasses.replace(per_knot, smem=shared.smem, tab_smem=shared.tab_smem) == shared


# knots per chunk of the Riccati kernel: at most 8192 staged values (8 lanes
# × 2n²+2nm+m²+n+m per knot), and the shared memory of four blocks per
# multiprocessor (two at n=13)
RICCATI_KNOTS = {
    (3, 2, "f32"): 16, (3, 2, "f64"): 8, (4, 1, "f32"): 16, (4, 1, "f64"): 8,
    (6, 2, "f32"): 4, (6, 2, "f64"): 2, (13, 4, "f32"): 2, (13, 4, "f64"): 1,
}


def _riccati_layout_bytes(n, m, itemsize, lanes, knots):
    """csrc/riccati.cu:RicLayout, counted here: two buffers, each a run per
    16 bytes of lanes of knots × (A, B, lxx, lxu, luu, lx, lu) × those
    lanes, a run rounded up to 128 bytes plus 64; then per lane the sweep's
    scratch P, p, PB, Quu, Qu, K, d, QK."""
    vec = 16 // itemsize
    entries = n * n + n * m + n * n + n * m + m * m + n + m
    run = -(-(knots * entries * vec * itemsize) // 128) * 128 + 64
    scratch = n * n + n + n * m + m * m + m + m * n + m + n * n
    return 2 * (lanes // vec) * run + -(-(lanes * scratch * itemsize) // 16) * 16


@pytest.mark.parametrize("B", [1, 1000, 1001, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,m", [(3, 2), (4, 1), (6, 2), (13, 4)])
def test_riccati_launch_geometry(n, m, dtype, B):
    tag = "f32" if dtype == torch.float32 else "f64"
    itemsize = torch.finfo(dtype).bits // 8
    g = RiccatiKernel(n, m, dtype=dtype).geometry(B)
    assert g.lanes == bf.LANES == 8 and g.group == bf.sweep_group(n) and g.group > n
    assert g.lanes * g.group % 32 == 0 and g.threads == g.lanes * g.group + 32 and g.threads <= 160
    assert g.tab_smem == 0
    assert g.knots == RICCATI_KNOTS[(n, m, tag)]
    assert g.smem == _riccati_layout_bytes(n, m, itemsize, g.lanes, g.knots) <= bf.SMEM_MAX
    # blocks on one multiprocessor: 233,472 bytes, 1,024 kept per block; four
    # (B=4096 in one wave), two at n=13, at least two at (13,4) f32
    blocks = 2 if n == 13 else 4
    assert blocks * (g.smem + 1024) <= 233_472
    if g.knots < bf.MAX_KNOTS:  # the largest chunk that fits both limits
        twice = _riccati_layout_bytes(n, m, itemsize, g.lanes, 2 * g.knots)
        per_knot = g.lanes * (2 * n * n + 2 * n * m + m * m + n + m)
        assert 2 * g.knots * per_knot > 8192 or blocks * (twice + 1024) > 233_472
    assert g.blocks == -(-B // 8)
    lanes = torch.arange(g.blocks)[:, None] * g.lanes + torch.arange(g.lanes)[None, :]
    assert torch.equal(torch.sort(lanes[lanes < B]).values, torch.arange(B))
