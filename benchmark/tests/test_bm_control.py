"""The control: the plain reference in bfloat16, in the program's place,
reads `correct` false in every cell (a few lanes on the CPU; on the card
at the cells' own sizes, `benchmark/calibrate.py --control`)."""
import time

import pytest
import torch

from benchmark.harness import runner


@pytest.mark.parametrize("cell_name", ["parking.fleet32k", "quadrotor.fleet8k", "parking.mpc32k"])
def test_bfloat16_control_reads_incorrect(small_cell, cell_name):
    cell = small_cell(cell_name)
    run = runner.Run(cell=cell, seed=2**31 + 99, seconds=0.05, t_start=time.perf_counter(), device=torch.device("cpu"))
    driver = runner.DRIVERS[cell.traffic["kind"]]
    sut = runner.make_sut(run, runner.CONTROL_DTYPE)
    driver.warm_up(run, sut)
    driver.window(run, sut)
    ok, checks, numbers = runner.correctness(run)
    assert not ok, (numbers, checks)
