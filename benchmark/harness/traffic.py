"""The one generator of the benchmark's traffic: a pool of `pool` fleets of
initial states, drawn on the card from the traffic file's `pool_seed` as
its `x0` block says; the order in which a run takes them, cycle by cycle,
drawn from the run's seed; and the seeded choice of what the check
samples.  Every run works through whole cycles of the same pool, so the
seed changes the order of the work and not the work; the same seed gives
the same order and samples on every run.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def stream(seed: int, *keys: int) -> int:
    """A generator seed for (seed, keys...), within 63 bits for any whole
    seed."""
    s = int(seed) & _MASK
    for k in keys:
        s = ((s ^ (int(k) & _MASK)) * _MIX + 0x632BE59BD9B4E019) & _MASK
    return s


def draw_x0(block: dict, x0: torch.Tensor, lanes: int, seed: int, index: int, device, dtype) -> torch.Tensor:
    """x0 [lanes, n] around the canonical x0 [n]: `uniform` in ±half_width
    or `normal` with std, drawn in float64 and cast; with
    `lane0_canonical` lane 0 keeps x0 itself."""
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, 1, index))
    n = x0.shape[-1]
    base = x0.to(device=device, dtype=torch.float64)
    if block["draw"] == "uniform":
        d = (torch.rand((lanes, n), generator=g, device=device, dtype=torch.float64) * 2.0 - 1.0) * block["half_width"]
    elif block["draw"] == "normal":
        d = torch.randn((lanes, n), generator=g, device=device, dtype=torch.float64) * block["std"]
    else:
        raise ValueError(f"unknown x0 draw {block['draw']!r}")
    out = base + d
    if block.get("lane0_canonical"):
        out[0] = base
    return out.to(dtype)


def member(traffic: dict, seed: int, index: int) -> int:
    """The pool member that the run's solve or episode `index` takes: the
    seeded permutation of the pool for the cycle `index` falls in."""
    P = int(traffic["pool"])
    g = torch.Generator().manual_seed(stream(seed, 3, index // P))
    return int(torch.randperm(P, generator=g)[index % P])


def pool_x0(traffic: dict, x0: torch.Tensor, lanes: int, which: int, device, dtype) -> torch.Tensor:
    """The pool member `which`'s initial states [lanes, n]."""
    return draw_x0(traffic["x0"], x0, lanes, traffic["pool_seed"], which, device, dtype)


def cycle_done(traffic: dict, index: int) -> bool:
    """Whether solve or episode `index` ends a cycle through the pool."""
    return (index + 1) % int(traffic["pool"]) == 0


def sample(seed: int, index: int, population: int, k: int, always: tuple = ()) -> list:
    """k distinct indices below `population` for the check, seeded by
    (seed, index), with `always` among them."""
    g = torch.Generator().manual_seed(stream(seed, 2, index))
    picked = [int(i) for i in always if i < population]
    for i in torch.randperm(population, generator=g).tolist():
        if len(picked) >= min(k, population):
            break
        if i not in picked:
            picked.append(i)
    return sorted(picked)
