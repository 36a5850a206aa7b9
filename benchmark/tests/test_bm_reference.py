"""The plain reference against altro-cpp's golden, and its arithmetic."""
import torch

from benchmark.harness import spec
from benchmark.reference import altro, problem
from benchmark.reference.arith import cholesky, cholesky_solve

GOLDEN_J = 0.03893465058924039  # test/augmented_lagrangian/auglag_test.cpp:346-349


def test_turn90_f64_reproduces_the_upstream_golden():
    """auglag_test.cpp:325-351: constraint tolerance 1e-6, from x0 = 0 and
    u = 0.1: SOLVED after 14 iterations, 5 outer, with the AL cost J."""
    torch.set_num_threads(1)
    p = problem.build(spec.load_json(spec.BENCH_DIR / "configs" / "parking.json")["problem"])
    r = altro.Solver(p, altro.options(constraint_tolerance=1e-6)).solve(p.x0[None], p.initial_controls(1))
    assert int(r["status"][0]) == altro.SOLVED
    assert int(r["iterations_total"][0]) == 14 and int(r["iterations_outer"][0]) == 5
    assert abs(float(r["cost_al"][0]) - GOLDEN_J) <= 1e-9 * GOLDEN_J


def test_bfloat16_factorization_matches_the_library():
    g = torch.Generator().manual_seed(0)
    A = torch.randn((6, 4, 4), generator=g, dtype=torch.float64)
    M = A @ A.transpose(-1, -2) + 4 * torch.eye(4, dtype=torch.float64)
    R = torch.randn((6, 4, 3), generator=g, dtype=torch.float64)
    L, failed = cholesky(M.to(torch.bfloat16))
    assert not failed.any()
    X = cholesky_solve(L, R.to(torch.bfloat16)).double()
    assert torch.allclose(X, torch.linalg.solve(M, R), rtol=0.1, atol=0.05)
    assert cholesky(-M.to(torch.bfloat16))[1].all()
