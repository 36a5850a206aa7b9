"""The port's whole slice — problem, batched AL-iLQR solver, kernel wiring
and straggler compaction — against the reference goldens and the JAX
package, float64 on the CPU (where the kernel wrappers run their plain
versions).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import to_batch_last
from altro_tpu.solver.compaction import CompactedALSolver as JCompacted
from altro_tpu_torch import SolverOptions, SolverStatus, convert
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.solver.compaction import CompactedALSolver

from _torch_fleet import numpy_tree

F64 = torch.float64
GOLDENS = Path(__file__).parent / "goldens"
REPO = Path(__file__).resolve().parent.parent
KERNELS = dict(backward_pass="fused", forward_pass="cuda")
# the solver options of each path: the eager passes, the fused kernels, and
# the Riccati kernel over the eager expansions (the JAX name "pallas")
PASSES = dict(scan={}, kernels=KERNELS, riccati=dict(backward_pass="pallas", forward_pass="cuda"))


def _fleet_Z(defn, B):
    Z0 = defn.initial_trajectory()
    return BatchedTrajectory(
        X=Z0.X[..., None].expand(-1, -1, B).contiguous(),
        U=Z0.U[..., None].expand(-1, -1, B).contiguous(), t=Z0.t, h=Z0.h,
    )


def _canonical_solve(opts, B=4):
    defn = UnicycleProblem(dtype=F64, device="cpu")
    prob = defn.make_problem().compile()
    solver = ALSolverBatched(prob, opts)
    params = prob.params.replace(x0=torch.zeros((3, B), dtype=F64))
    return solver, params, solver.solve(params, _fleet_Z(defn, B))


@pytest.mark.parametrize("passes", sorted(PASSES))
def test_control_parity_golden(passes):
    """As tests/test_control_parity.py:74-84 does for JAX: the f64 batched
    solve equals the f64 reference solve (U to 1e-10, same iterations)."""
    g = np.load(GOLDENS / "unicycle_turn90_refsolve_f64.npz")
    solver, _, res = _canonical_solve(SolverOptions(**PASSES[passes]))
    assert (solver._bwd is not None) == (passes == "kernels")
    assert (solver._ric is not None) == (passes == "riccati")
    U = res["Z"].U.numpy()
    for b in range(U.shape[-1]):
        np.testing.assert_allclose(U[..., b], g["U"], rtol=0, atol=1e-10)
    assert (res["status"].numpy() == int(SolverStatus.SOLVED)).all()
    assert (res["stats"].iterations_total.numpy() == int(g["iterations_total"])).all()


@pytest.mark.parametrize("passes", sorted(PASSES))
def test_al_golden_14_5(passes):
    """Constraint tolerance 1e-6: 14 total / 5 outer iterations and
    J = 0.03893465058924039 (`auglag_test.cpp:325-351`)."""
    solver, params, res = _canonical_solve(SolverOptions(constraint_tolerance=1e-6, **PASSES[passes]))
    assert (res["status"].numpy() == int(SolverStatus.SOLVED)).all()
    assert (res["stats"].iterations_total.numpy() == 14).all()
    assert (res["stats"].iterations_outer.numpy() == 5).all()
    J = solver.total_cost(params, res["al"], res["Z"]).numpy()
    np.testing.assert_allclose(J, 0.03893465058924039, rtol=1e-9)
    assert solver.host_syncs > 0


def test_generic_cost_path_matches_golden():
    """A stage cost given as an opaque function (AD expansion through
    torch.func) solves to the same golden; the kernels decline the problem
    once, at construction, and the eager passes run."""
    from altro_tpu_torch import Cost
    from altro_tpu_torch.problem.costs import _quadcost_eval

    g = np.load(GOLDENS / "unicycle_turn90_refsolve_f64.npz")
    defn = UnicycleProblem(dtype=F64, device="cpu")
    builder = defn.make_problem()
    stage = builder._costs[0]
    builder.set_cost(Cost(params=stage.params, fn=lambda p, x, u: _quadcost_eval(p, x, u)), range(defn.N))
    prob = builder.compile()
    solver = ALSolverBatched(prob, SolverOptions(**KERNELS))
    assert solver._bwd is None and solver._fwd is None
    res = solver.solve(prob.params.replace(x0=torch.zeros((3, 2), dtype=F64)), _fleet_Z(defn, 2))
    np.testing.assert_allclose(res["Z"].U[..., 0].numpy(), g["U"], rtol=0, atol=1e-10)
    assert int(res["stats"].iterations_total[0]) == int(g["iterations_total"])


@pytest.fixture(scope="module")
def jax_compacted():
    """JAX CompactedALSolver(device_tail=True), scan passes, on a B=16
    perturbed fleet (tests/test_compaction.py:_fleet, N=30)."""
    defn = JUnicycle()
    defn.N = 30
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    B = 16
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(rng.uniform(-0.4, 0.4, size=(3, B))).at[:, 0].set(0.0)
    params = prob.params.replace(x0=x0s)
    Zb = to_batch_last(
        jax.tree_util.tree_map(lambda l: jnp.broadcast_to(l, (B,) + l.shape), defn.initial_trajectory())
    )
    solver = JCompacted(
        prob, JOptions(backward_pass="scan", forward_pass="scan"),
        phase1_iters=5, tail_batch=8, device_tail=True,
    )
    return params, Zb, numpy_tree(solver.solve(params, Zb))


@pytest.mark.parametrize("passes", sorted(PASSES))
def test_compaction_matches_jax_device_tail(jax_compacted, passes):
    """phase1_iters=5, tail_batch=8: the tail gathers real stragglers over
    two rounds (as tests/test_compaction.py:145-154); lane by lane the
    same status, iteration count and U (1e-9).  With "riccati" the phase-1
    and tail solvers inherit the option and each builds the wrapper."""
    params_j, Z_j, ref = jax_compacted
    prob = UnicycleProblem(dtype=F64, N=30, device="cpu").make_problem().compile()
    comp = CompactedALSolver(prob, SolverOptions(**PASSES[passes]), phase1_iters=5, tail_batch=8, device_tail=True)
    if passes == "riccati":
        assert comp._p1._ric is not None and comp._tail._ric is not None
    res = comp.solve(
        convert.problem_params(numpy_tree(params_j), "cpu", F64),
        convert.trajectory(numpy_tree(Z_j), "cpu", F64),
    )
    assert comp.telemetry["tail_rounds"] == 2
    np.testing.assert_array_equal(res["status"].numpy(), ref["status"])
    np.testing.assert_array_equal(res["stats"].iterations_total.numpy(), ref["stats"].iterations_total)
    np.testing.assert_array_equal(res["stats"].iterations_outer.numpy(), ref["stats"].iterations_outer)
    np.testing.assert_allclose(res["Z"].U.numpy(), ref["Z"].U, rtol=0, atol=1e-9)
    assert comp.host_syncs > 0


def test_outer_constraints_f64_matches_jax():
    """`outer_constraints_f64` on a float32 problem: the dual update and the
    violation are computed in float64 and cast back, as in the JAX package."""
    from altro_tpu.solver.batched import ALSolverBatched as JSolver
    from _torch_fleet import make_fleet

    fl = make_fleet(12, 8, seed=4, spread=0.2)
    f32 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), t)  # noqa: E731
    defn = JUnicycle(dtype=jnp.float32)
    defn.N = 12
    defn.__post_init__()
    prob_j = defn.make_problem(add_constraints=True).compile()
    params_j = prob_j.params.replace(x0=f32(fl.params_j.x0))
    Z_j = fl.Z_j.replace(X=f32(fl.Z_j.X), U=f32(fl.Z_j.U), t=f32(fl.Z_j.t), h=f32(fl.Z_j.h))
    al_j = f32(fl.al_j)
    upd = np.arange(8) % 3 != 0
    al_ref, viol_ref = JSolver(prob_j, JOptions(outer_constraints_f64=True))._outer_duals_and_violation(
        params_j, Z_j, al_j, jnp.asarray(upd)
    )
    prob = UnicycleProblem(dtype=torch.float32, N=12, device="cpu").make_problem().compile()
    solver = ALSolverBatched(prob, SolverOptions(outer_constraints_f64=True))
    al, viol = solver._outer_duals_and_violation(
        convert.problem_params(numpy_tree(params_j), "cpu", torch.float32),
        convert.trajectory(numpy_tree(Z_j), "cpu", torch.float32),
        convert.al_state(numpy_tree(al_j), "cpu", torch.float32),
        torch.as_tensor(upd),
    )
    assert viol.dtype == torch.float32
    np.testing.assert_allclose(viol.numpy(), np.asarray(viol_ref), rtol=1e-6)
    for st, st_ref in zip(al, al_ref):
        np.testing.assert_allclose(st["lam"].numpy(), np.asarray(st_ref["lam"]), rtol=1e-6, atol=1e-7)


def test_chip_smoke_runs_the_bench_program():
    """chip_smoke.py's main path is bench.py's program: same options (the
    JAX "pallas" forward pass is the port's "cuda"), phase-1 cap and tail
    width."""
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(f"_{name}", REPO / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    bench, chip_smoke = load("bench"), load("chip_smoke")

    want = dict(bench._BENCH_OPT_KW, forward_pass="cuda")
    assert chip_smoke.BENCH_OPT_KW == want
    assert (chip_smoke.PHASE1_ITERS, chip_smoke.TAIL_BATCH) == (bench.PHASE1_ITERS, bench.TAIL_BATCH)
    assert SolverOptions(**bench._BENCH_OPT_KW) == SolverOptions(**chip_smoke.BENCH_OPT_KW)


def test_port_never_imports_jax_at_runtime():
    """Importing altro_tpu_torch (every module, the multi-device layer, the
    associative-scan sweeps and the utilities too) and running a tiny solve
    leaves jax and the JAX package out of sys.modules."""
    code = (
        "import sys, torch\n"
        "from altro_tpu_torch import SolverOptions\n"
        "from altro_tpu_torch.models.problems import UnicycleProblem\n"
        "from altro_tpu_torch.solver.compaction import CompactedALSolver\n"
        "from altro_tpu_torch.solver.batched import BatchedTrajectory\n"
        "d = UnicycleProblem(N=10, device='cpu')\n"
        "p = d.make_problem().compile()\n"
        "Z0 = d.initial_trajectory()\n"
        "Z = BatchedTrajectory(Z0.X[..., None].repeat(1, 1, 2), Z0.U[..., None].repeat(1, 1, 2), Z0.t, Z0.h)\n"
        "s = CompactedALSolver(p, SolverOptions(backward_pass='fused', forward_pass='cuda'), phase1_iters=3, tail_batch=2)\n"
        "r = s.solve(p.params.replace(x0=torch.zeros(3, 2, dtype=torch.float64)), Z)\n"
        "assert r['status'].shape == (2,)\n"
        "s = CompactedALSolver(p, SolverOptions(backward_pass='pallas'), phase1_iters=3, tail_batch=2)\n"
        "assert s.solve(p.params.replace(x0=torch.zeros(3, 2, dtype=torch.float64)), Z)['status'].shape == (2,)\n"
        "from altro_tpu_torch.models.problems import TripleIntegratorProblem, zoo_cartpole, zoo_quadrotor\n"
        "import altro_tpu_torch.ops.riccati, altro_tpu_torch.ops._build\n"
        "import altro_tpu_torch.utils.timer\n"
        "import altro_tpu_torch.parallel.batch, altro_tpu_torch.parallel.mesh, altro_tpu_torch.native\n"
        "import altro_tpu_torch.solver.pscan, altro_tpu_torch.solver.pscan_batched\n"
        "import altro_tpu_torch.utils.checkpoint, altro_tpu_torch.utils.derivative_check\n"
        "import altro_tpu_torch.utils.benchmarking\n"
        "from altro_tpu_torch import MPC\n"
        "m = MPC(p, SolverOptions(max_iterations_total=1))\n"
        "assert m.step(m.init(Z0), torch.zeros(3, dtype=torch.float64))[0].shape == (2,)\n"
        "zoo_quadrotor(N=4, device='cpu'); zoo_cartpole(N=4, device='cpu')\n"
        "TripleIntegratorProblem(device='cpu').make_problem(add_constraints=True).compile()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'altro_tpu']\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_chip_smoke_plain_stage_leaves_no_process():
    """chip_smoke's plain stage (run_plain) ends every process it started,
    multiprocessing's resource tracker included, when its solves succeed,
    when one fails, and when SIGTERM (a time limit's) arrives meanwhile."""
    code = (
        "import os, signal, sys, time\n"
        "import chip_smoke as cs\n"
        "kids = lambda: sorted(cs._children())\n"
        "seen = []\n"
        "r = cs.run_plain([('a', [('x', dict, ()), ('y', dict, ())], lambda res, wall: sorted(res))],\n"
        "                 during=lambda: seen.append(len(kids())))\n"
        "assert r == {'a': ['x', 'y']} and seen == [3], (r, seen)  # two solves and the tracker\n"
        "assert kids() == [], kids()\n"
        "try:\n"
        "    cs.run_plain([('a', [('x', time.sleep, (60,)), ('y', time.sleep, (0.01,))], None)])\n"
        "except AssertionError as e:\n"
        "    assert 'plain solve y' in str(e), e\n"
        "assert kids() == [], kids()\n"
        "signal.signal(signal.SIGTERM, cs._end_on_sigterm)\n"
        "t0 = time.perf_counter()\n"
        "try:\n"
        "    cs.run_plain([('a', [('x', time.sleep, (60,))], None)],\n"
        "                 during=lambda: os.kill(os.getpid(), signal.SIGTERM))\n"
        "except SystemExit as e:\n"
        "    assert e.code == 128 + signal.SIGTERM, e.code\n"
        "assert kids() == [] and time.perf_counter() - t0 < 30, kids()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_chip_smoke_ends_what_is_left_running():
    """chip_smoke's last guard (_run): a child still running when main
    returns, and an orphaned grandchild (the script is their subreaper), are
    killed, reaped and named; a child that ended is reaped unnamed."""
    code = (
        "import subprocess, sys, time\n"
        "import chip_smoke as cs\n"
        "ended = []  # held, so that the Popen object's finalizer cannot reap the ended child first\n"
        "def fake_main(argv):\n"
        "    subprocess.Popen(['sleep', '61'])\n"
        "    subprocess.Popen(['sh', '-c', 'sleep 62 & exit 0']).wait()\n"
        "    ended.append(subprocess.Popen(['true']))\n"
        "    time.sleep(0.5)\n"
        "    assert len(cs._children()) == 3, cs._children()  # sleep 61, the orphan, the ended true\n"
        "    return 7\n"
        "cs.main = fake_main\n"
        "assert cs._run([]) == 7\n"
        "assert cs._children() == {}, cs._children()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
    assert "ended 2 process(es) left running" in out.stderr, out.stderr
    assert "sleep 61" in out.stderr and "sleep 62" in out.stderr, out.stderr


def test_port_sources_do_not_import_jax():
    files = list((REPO / "altro_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("import altro_tpu ") or s.startswith("from altro_tpu ")
                        or s.startswith("from altro_tpu.") or s == "import altro_tpu"), (path, line)
