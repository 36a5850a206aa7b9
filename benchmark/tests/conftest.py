"""Fixtures of the benchmark's CPU tests: the repository root on the
import path, and cells cut to a size the CPU runs in seconds."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def small_cell():
    """`small_cell(name)`: the cell with its traffic cut to a few lanes
    (fleet) or a few controllers and ticks (mpc); everything else as in
    its files."""
    import torch

    from benchmark.harness import spec

    torch.set_num_threads(2)

    def make(name: str):
        cell = copy.deepcopy(spec.load_cell(name))
        t = cell.traffic
        if t["kind"] == "fleet":
            t.update(lanes=4, pool=1, warm_solves=1, check=dict(lanes_per_solve=4))
        else:
            t.update(controllers=4, pool=1, ticks_per_episode=4, warm_ticks=1,
                     check=dict(ticks_per_episode=4, lanes_per_tick=4))
        return cell

    return make
