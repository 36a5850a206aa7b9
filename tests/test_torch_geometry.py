"""The kernels' launch geometry and the fused kernels' problem descriptor,
as the wrappers compute them on the host (no card needed).

For every model with a device functor, both scalar types and both fused
kernels, at B in {1, 1000, 2048, 4096}: the block's dynamic shared memory
fits the H100's 232,448 bytes, B >= 2048 launches at least one block per
multiprocessor (132), every batch lane falls in exactly one block, and the
geometry passes the checks the kernels' launchers make
(`csrc/backward_fused.cuh:launch_backward`, `csrc/forward.cuh:
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
from altro_tpu_torch.models.problems import TripleIntegratorProblem, UnicycleProblem, zoo_cartpole, zoo_quadrotor
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
    if model == "triple_integrator2":
        return TripleIntegratorProblem(dtype=dtype, device="cpu").make_problem(add_constraints=True).compile()
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


@pytest.mark.parametrize("B", [1, 1001, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_triple_integrator_geometry(kind, dtype, B):
    """The (6, 2) instantiations (`csrc/models.cuh:TripleIntegrator<2>`,
    TripleIntegratorProblem with its control bound and goal, N=10): both
    fused kernels take the model, and their geometry is the one the
    launchers check, with the knots per chunk that `chunk_knots` derives
    from n=6, m=2 and the scalar type, the shared memory of that chunk, and
    the cost table staged."""
    prob = _problem("triple_integrator2", dtype)
    kern = KERNELS[kind](prob, SolverOptions(), dtype=dtype, device="cpu")
    assert kern.model_name == "triple_integrator2" and bf.CUDA_MODELS["triple_integrator2"] == (6, 2, ())
    assert kern._entry(frozenset()) == f"altro_{kind}_triple_integrator2_{'f32' if dtype == torch.float32 else 'f64'}"
    assert f"altro_{kind}_lanes_triple_integrator2_f64" in _build.ENTRY_POINTS
    g = kern.geometry(B)
    item = torch.finfo(dtype).bits // 8
    assert g.blocks == -(-B // bf.LANES) and g.lanes == bf.LANES
    tab = g.tab_smem
    assert tab == kern._problem_desc(prob.params)[1].numel()  # two rows of 6·6 + 2·2 + 6·2 + 6 + 2 + 1
    if kind == "backward_fused":
        want = bf.chunk_knots(bf.LANES * (6 + 2 + 1), bf.PRODUCER_ROUNDS * bf.PRODUCERS,
                              lambda k: bf.backward_smem(6, 2, item, bf.LANES, k, bf.TABLE_SMEM // item))
        assert g.knots == want and g.smem == bf.backward_smem(6, 2, item, bf.LANES, want, tab)
        assert g.group == 8 and g.threads == bf.LANES * 8 + bf.PRODUCERS
    else:
        want = bf.chunk_knots(bf.LANES * (6 + 2 * 2 + 2 * 6 + kern.Ps + kern.Fs), bf.STAGE_WORDS,
                              lambda k: bf.forward_smem(6, 2, item, bf.LANES, k, bf.TABLE_SMEM // item,
                                                        kern.Ps, kern.Fs))
        assert g.knots == want and g.smem == bf.forward_smem(6, 2, item, bf.LANES, want, tab, kern.Ps, kern.Fs)
        assert g.threads == bf.FWD_THREADS
    assert g.knots in (1, 2, 4, 8, 16) and g.smem <= bf.SMEM_MAX


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


# ---------------------------------------------------------------- per-lane params
def _randomized(dtype, N=10, B=5):
    from altro_tpu_torch.models.problems import randomized_fleet

    defn = UnicycleProblem(scenario="three_obstacles", dtype=dtype, device="cpu", N=N)
    prob = defn.make_problem().compile()
    return prob, randomized_fleet(defn, prob, B, seed=0)[0]


def test_lane_table_packs_per_knot_rows_then_static_rows():
    """The randomized fleet's lane table: per knot k the cost family's q
    (3 rows) and c (1 row) from row 4k on, then the static rows of the
    circle's cx, cy, r and the goal's xf; every value as the leaf holds
    it."""
    N, B = 10, 5
    prob, params = _randomized(torch.float64, N, B)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float64, device="cpu")
    sig = kern.param_sig(params)
    lay = kern._lane_layout(sig)
    assert (lay.knot_rows, lay.static_rows) == (4, 12)
    tab = kern.lane_table(params, sig, B)
    assert tab.shape == ((N + 1) * 4 + 12, B) and tab.is_contiguous()
    cost = params.costs[0]
    for k in range(N + 1):
        assert torch.equal(tab[4 * k: 4 * k + 3], cost["q"][k]) and torch.equal(tab[4 * k + 3], cost["c"][k])
    kinds = [f.constraint.structure[0] for f in prob.constraint_families]
    circle, goal = params.constraints[kinds.index("circle")], params.constraints[kinds.index("goal")]
    static = tab[(N + 1) * 4:]
    assert torch.equal(static, torch.cat([circle["cx"], circle["cy"], circle["r"], goal["xf"]]))
    with pytest.raises(ValueError):  # a per-lane leaf of another width than the launch's
        kern.lane_table(params, sig, B + 1)


def test_lane_descriptor_points_each_per_lane_leaf_at_its_rows():
    """AltroLanes of the randomized fleet: both families the stacked cost
    folds into (stage knots, terminal knot) read q and c per knot at their
    rows, every other cost leaf and the dynamics from the descriptor; the
    circle's a, b, r and the goal's a at their static rows.  The descriptor
    holds zeros in their place, and the fold is the shared problem's."""
    N, B = 10, 5
    prob, params = _randomized(torch.float64, N, B)
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float64, device="cpu")
    sig = kern.param_sig(params)
    desc, table = kern._problem_desc(params, sig)
    ln, ln_dev = kern._lanes
    assert bytes(ln) == bytes(ln_dev.numpy())
    d = _build.Problem.from_buffer_copy(bytes(desc.numpy()))
    assert [(f.k0, f.k1, f.stacked) for f in d.cost[: d.n_cost]] == [(0, N - 1, 0), (N, N, 0)]
    src = lambda s: (s.off, s.kstride)  # noqa: E731
    for fam in range(2):
        assert [src(s) for s in ln.cost[fam]] == [(-1, 0)] * 3 + [(0, 4), (-1, 0), (3, 4)]
    assert all(s.off == -1 for s in ln.dyn)
    kinds = [f.constraint.structure[0] for f in prob.constraint_families]
    ci, gi, bi = kinds.index("circle"), kinds.index("goal"), kinds.index("control_bound")
    assert [src(s) for s in ln.con[ci]] == [(0, 0), (3, 0), (6, 0)]
    assert [src(s) for s in ln.con[gi]][0] == (9, 0) and all(s.off == -1 for s in ln.con[bi])
    assert list(d.con[ci].a[:3]) == list(d.con[ci].b[:3]) == list(d.con[ci].r[:3]) == [0.0] * 3
    assert list(d.con[gi].a[:3]) == [0.0] * 3
    row = 9 + 4 + 6 + 3 + 2 + 1  # Q, R, H, q, r, c of n=3, m=2
    assert table.numel() == 2 * row and bool((table[[9 + 4 + 6 + i for i in (0, 1, 2, 5)]] == 0).all())
    # a tail round's gathered leaves (new tensors, same shared leaves) keep the descriptor
    from altro_tpu_torch.solver.batched import gather_params

    kern._problem_desc(gather_params(prob.params, params, torch.tensor([4, 0])), sig)
    assert kern._desc[0] is desc


def _per_lane(model, dtype, B):
    """(problem, params) with one per-lane leaf: the randomized fleet's six
    for the unicycle, the pole mass for the cartpole, the inertia J [3, B]
    for the quadrotor."""
    if model == "unicycle":
        return _randomized(dtype, 100, B)
    prob = _problem(model, dtype)
    key = "J" if model == "quadrotor" else "mass_pole"
    leaf = prob.params.dynamics[0][key]
    return prob, prob.params.replace(
        dynamics=(dict(prob.params.dynamics[0], **{key: leaf[..., None].expand(*leaf.shape, B).clone()}),))


@pytest.mark.parametrize("B", [1, 1001, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model", ["unicycle", "cartpole", "quadrotor"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_lane_geometry_counts_the_lane_rows(kind, model, dtype, B):
    """The lane-params instantiation's geometry: the layout of
    csrc/{backward_fused,forward}.cu with the lanes descriptor, the lane
    rows per knot (W), the static rows (S) and, in the backward slot, the
    cost Hessians' sums; within the card's shared memory, the forward
    chunk's staged words within STAGE_WORDS, the checks of
    test_launch_geometry, and the shared-param geometry where no leaf is
    per lane."""
    prob, params = _per_lane(model, dtype, B)
    kern = KERNELS[kind](prob, SolverOptions(), dtype=dtype, device="cpu")
    sig = kern.param_sig(params)
    assert len(sig) == (6 if model == "unicycle" else 1) and kern.takes(params)
    lay = kern._lane_layout(sig)
    g = kern.geometry(B, params)
    item = torch.finfo(dtype).bits // 8
    n, m = prob.n, prob.m
    lane = (lay.knot_rows, lay.static_rows)
    if kind == "backward_fused":
        assert g.smem == bf.backward_smem(n, m, item, g.lanes, g.knots, g.tab_smem, lane)
        assert g.knots == bf.chunk_knots(g.lanes * (n + m + 1), bf.PRODUCER_ROUNDS * bf.PRODUCERS,
                                         lambda k: bf.backward_smem(n, m, item, g.lanes, k, bf.TABLE_SMEM // item, lane))
    else:
        assert g.smem == bf.forward_smem(n, m, item, g.lanes, g.knots, g.tab_smem, kern.Ps, kern.Fs, lane)
        assert g.knots * g.lanes * (n + 2 * m + m * n + kern.Ps + kern.Fs + lay.knot_rows) <= bf.STAGE_WORDS
    assert g.smem <= bf.SMEM_MAX and g.blocks == -(-B // g.lanes) and g.threads % 32 == 0
    shared = kern.geometry(B)
    assert kern._layout(g.tab_smem).knots >= g.knots
    assert dataclasses.replace(g, smem=0, knots=0) == dataclasses.replace(shared, smem=0, knots=0, tab_smem=g.tab_smem)


def test_lane_rows_shrink_the_chunks_until_no_chunk_fits():
    """Per-knot and per-lane Q, R, H and q of the quadrotor in f64 (254 lane
    rows a knot) still fit the card's shared memory: the backward chunk
    shrinks from 4 knots to 2.  Rows beyond every layout `param_sig` admits
    (here 5,000 a knot) leave no chunk, and the layout raises instead of
    routing the solve away from the kernel; `takes` is False only for what
    `param_sig` refuses."""
    prob = _problem("quadrotor", torch.float64)
    B = 4
    costs = dict(prob.params.costs[0])
    for key in ("Q", "R", "H", "q"):
        costs[key] = costs[key][..., None].expand(*costs[key].shape, B).clone()
    params = prob.params.replace(costs=(costs,))
    kern = BackwardFusedKernel(prob, SolverOptions(), dtype=torch.float64, device="cpu")
    assert {"cost0_Q", "cost0_R", "cost0_H", "cost0_q"} <= kern.param_sig(params) and kern.takes(params)
    assert kern._lane_layout(kern.param_sig(params)).knot_rows == 13 * 13 + 4 * 4 + 13 * 4 + 13
    assert (kern.geometry(B).knots, kern.geometry(B, params).knots) == (4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        kern._layout(0, (5000, 0))
    costs["q"] = torch.zeros((prob.N + 1, 13, 5000, B), dtype=torch.float64)
    assert not kern.takes(prob.params.replace(costs=(costs,)))  # a rank the kernels refuse


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model", ["unicycle", "cartpole", "quadrotor"])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_every_lane_table_param_sig_admits_fits(kind, model, dtype):
    """The largest lane table the descriptor can describe leaves a chunk
    within the shared memory beside the largest staged cost table: all six
    leaves of MAX_FAMS/2 cost families per lane (the most eligibility
    takes), each family stacked per knot or not in every split, the leaves
    of MAX_FAMS constraint families of up to NMAX rows (3·NMAX for a
    circle family) and NDYN dynamics params.  So `takes`, which refuses
    only what `param_sig` refuses, never hands a kernel a layout it cannot
    launch."""
    prob = _problem(model, dtype)
    kern = KERNELS[kind](prob, SolverOptions(), dtype=dtype, device="cpu")
    n, m = prob.n, prob.m
    fam = n * n + m * m + n * m + n + m + 1
    cost_fams = _build.MAX_FAMS // 2
    static = _build.MAX_FAMS * max(n, 2 * m, 3 * _build.NMAX) + _build.NDYN
    for stacked in range(cost_fams + 1):
        g = kern._layout(bf.TABLE_SMEM // kern._itemsize, (stacked * fam, (cost_fams - stacked) * fam + static))
        assert g.knots >= 1 and g.smem <= bf.SMEM_MAX
