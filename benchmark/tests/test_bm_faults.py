"""The check catches a broken timed path: each cell's run on the CPU, past
the harness's look for a card, with the program broken underneath, reads
`correct` false; the same run with the program whole reads it true, and
so does nothing else.  The faults a cell can have: a solve or tick that
returns its state unchanged, half of the batch left out (the other half's
answers in its place), and an answer altered where it is produced; a
controller besides: a tick that moves its controls but carries its AL
state unchanged, or carries another lane's."""
import time

import pytest
import torch

from benchmark.harness import runner

CELLS = ["parking.fleet32k", "quadrotor.fleet8k", "parking.mpc32k"]
FAULTS = ["sound", "unchanged", "half", "altered"]
CASES = [(c, f) for c in CELLS for f in FAULTS] + [("parking.mpc32k", f) for f in ("al_unchanged", "al_other_lane")]


class Broken:
    """A system under test with one fault planted under its interface."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # fleet
    def solve(self, x0):
        if self.fault == "unchanged":
            Z = self.inner.Zb
            B = x0.shape[0]
            return dict(X=Z.X.permute(2, 0, 1), U=Z.U.permute(2, 0, 1), solved=torch.ones(B, dtype=torch.bool))
        out = self.inner.solve(x0)
        return self._break(out, ("X", "U", "solved"))

    # controller
    def step(self, state, x):
        if self.fault == "unchanged":
            return state.Z.U[0].T, state, state.status == 0
        u, new, solved = self.inner.step(state, x)
        if self.fault == "al_unchanged":
            new = new.replace(al=state.al)
        elif self.fault == "al_other_lane":
            new = new.replace(al=tuple({k: v.roll(1, dims=-1) for k, v in fam.items()} for fam in new.al))
        return self._break(dict(u=u), ("u",))["u"], new, solved

    def _break(self, out, keys):
        out = {k: v.clone() if torch.is_tensor(v) else v for k, v in out.items()}
        B = out[keys[0]].shape[0]
        if self.fault == "half":
            for k in keys:
                out[k][B // 2:] = out[k][: B - B // 2][: B // 2]
        elif self.fault == "altered":
            main = keys[1] if len(keys) > 1 else keys[0]
            out[main][..., 0] += 1e-2
        return out


@pytest.fixture(scope="module")
def systems():
    return {}


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_fault_reads_incorrect(small_cell, systems, cell_name, fault):
    cell = small_cell(cell_name)
    dev = torch.device("cpu")
    run = runner.Run(cell=cell, seed=2**32 + 11, seconds=0.05, t_start=time.perf_counter(), device=dev)
    driver = runner.DRIVERS[cell.traffic["kind"]]
    if cell_name not in systems:
        sut = runner.make_sut(run)
        driver.warm_up(run, sut)
        systems[cell_name] = sut
    driver.window(run, Broken(systems[cell_name], fault))
    ok, checks, numbers = runner.correctness(run)
    assert ok == (fault == "sound"), (numbers, checks)
