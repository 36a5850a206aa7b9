"""Live fleet rows of the port's batched solver against the JAX package's,
float64 on the CPU.

At `verbose` >= OUTER the JAX package prints one fleet row per lockstep
outer iteration, and at INNER one per inner iteration too
(`altro_tpu/solver/batched.py:_emit_outer_row`, `_emit_inner_row`;
tests/test_batched_observability.py).  The port prints the same rows after
one read of the device's values each, counted in `host_syncs`.  Held here
on the parking problem at N=30, B=4 (tests/test_batched_observability.py:
18-30): the same rows in the same order, each column's number equal (to
1e-6, the printed precision's far side) field by field; the sync count of
a logged solve exceeds the SILENT solve's by exactly its rows; SILENT
prints nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from altro_tpu import LogLevel as JLevel
from altro_tpu import SolverOptions as JOptions
from altro_tpu.models.problems import UnicycleProblem as JUnicycle
from altro_tpu.solver.batched import ALSolverBatched as JSolver
from altro_tpu.solver.batched import to_batch_last
from altro_tpu_torch import LogLevel, SolverOptions
from altro_tpu_torch.models.problems import UnicycleProblem
from altro_tpu_torch.solver.batched import ALSolverBatched, BatchedTrajectory
from altro_tpu_torch.utils.logging import LogEntry, SolverLogger

from _torch_fleet import one_torch_thread  # noqa: F401

# small eager ops: one torch thread each (tests/_torch_fleet.py)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B = 30, 4


def _jax_rows(level, capsys):
    defn = JUnicycle(dtype=jnp.float64)
    defn.N = N
    defn.__post_init__()
    prob = defn.make_problem(add_constraints=True).compile()
    Zb = to_batch_last(jax.tree_util.tree_map(lambda leaf: jnp.broadcast_to(leaf, (B,) + leaf.shape),
                                              defn.initial_trajectory()))
    res = jax.jit(JSolver(prob, JOptions(verbose=JLevel(int(level)))).solve)(prob.params, Zb)
    jax.block_until_ready(res["status"])
    jax.effects_barrier()
    return capsys.readouterr().out


def _port(level, capsys):
    defn = UnicycleProblem(dtype=torch.float64, N=N, device="cpu")
    prob = defn.make_problem().compile()
    Z0 = defn.initial_trajectory()
    Zb = BatchedTrajectory(Z0.X[..., None].expand(-1, -1, B).contiguous(),
                           Z0.U[..., None].expand(-1, -1, B).contiguous(), Z0.t, Z0.h)
    solver = ALSolverBatched(prob, SolverOptions(verbose=level))
    res = solver.solve(prob.params, Zb)
    return capsys.readouterr().out, solver.host_syncs, res


def _fields(line, logger):
    """A data row cut into its active columns by their widths."""
    out, pos = {}, 0
    for title in logger._order:
        if not logger.active(title):
            continue
        w = logger.entries[title].width
        cell = line[pos: pos + w].strip()
        pos += w
        out[title] = cell
    return out


def _data(out):
    return [ln for ln in out.splitlines() if ln.strip() and ln.strip()[0].isdigit()]


@pytest.mark.parametrize("level", [LogLevel.OUTER, LogLevel.INNER], ids=["outer", "inner"])
def test_rows_hold_the_jax_packages_numbers(level, capsys):
    want = _data(_jax_rows(level, capsys))
    out, syncs, res = _port(level, capsys)
    got = _data(out)
    assert "iter_al" in out and "viol_max" in out
    n_outer = int(res["stats"].iterations_outer.max())
    n_total = int(res["stats"].iterations_total.max())
    assert len(got) == (n_outer if level == LogLevel.OUTER else n_outer + n_total)
    assert len(got) == len(want)
    logger = SolverLogger(level, fleet=True)
    for g, w in zip(got, want):
        fg, fw = _fields(g, logger), _fields(w, logger)
        assert fg.keys() == fw.keys()
        for title in fg:
            if fw[title] == "" or logger.entries[title].is_int:
                assert fg[title] == fw[title], (title, g, w)
            else:
                np.testing.assert_allclose(float(fg[title]), float(fw[title]), rtol=1e-6, atol=0, err_msg=title)
    if level == LogLevel.OUTER:  # the last row reports every lane SOLVED
        assert got[-1].split()[1] == str(B)

    silent_out, silent_syncs, silent_res = _port(LogLevel.SILENT, capsys)
    assert silent_out == ""
    assert syncs == silent_syncs + len(got)
    assert torch.equal(res["Z"].U, silent_res["Z"].U) and torch.equal(res["status"], silent_res["status"])


def test_silent_solver_builds_no_logger():
    prob = UnicycleProblem(dtype=torch.float64, N=N, device="cpu").make_problem().compile()
    assert ALSolverBatched(prob, SolverOptions())._logger is None
    assert ALSolverBatched(prob, SolverOptions(verbose=LogLevel.OUTER))._logger is not None


def test_log_entry_formats_as_the_jax_package():
    from altro_tpu.utils.logging import LogEntry as JEntry

    for entry, jentry, value in (
        (LogEntry("viol", "{:>.3e}", 12, LogLevel.OUTER, upper_bound=1.0),
         JEntry("viol", "{:>.3e}", 12, JLevel.OUTER, upper_bound=1.0), 3.25),
        (LogEntry("iters", "{:>4d}", 6, is_int=True), JEntry("iters", "{:>4d}", 6, is_int=True), 17),
    ):
        for color in (False, True):
            assert entry.format_value(value, color) == jentry.format_value(value, color)
