"""Traffic of kind `mpc`: a fleet of receding-horizon controllers closing
the loop with a simulated plant, in episodes of `ticks_per_episode` ticks,
each episode from the initial states of the pool member the seed's order
gives it.  A tick is timed on the host from the measured states' arrival
(the plant's step done) to the controls on the host.  The window holds
whole cycles through the pool, so that every run has the same episodes,
cold first ticks and warm ones alike: it closes at the end of the cycle
during which `--seconds` pass.
"""
from __future__ import annotations

import time

import torch

from . import traffic as tr
from ..reference.models import dynamics, rk4
from .trace import span, traced


class Plant:
    """The simulated vehicles: the configuration's model under RK4 in the
    run's precision, lanes first."""

    def __init__(self, run):
        pb = run.cell.config["problem"]
        self.f = dynamics(pb["model"])
        self.params = {k: torch.as_tensor(v, dtype=run.dtype, device=run.device)
                       for k, v in pb.get("model_params", {}).items()}
        self.h = run.ref_problem.h

    def __call__(self, x, u):
        return rk4(self.f, self.params, x, u, self.h)


def _x0(run, which):
    t = run.cell.traffic
    return tr.pool_x0(t, run.x0_canonical, t["controllers"], which, run.device, run.dtype)


def warm_up(run, sut) -> None:
    t = run.cell.traffic
    plant = Plant(run)
    state, x = sut.init(t["controllers"]), _x0(run, 0)
    for _ in range(int(t.get("warm_ticks", 2))):
        u, state, _ = sut.step(state, x)
        u.cpu()
        x = plant(x, u)
    run.sync()


def window(run, sut) -> None:
    t = run.cell.traffic
    B, T = t["controllers"], int(t["ticks_per_episode"])
    ck = t["check"]
    plant = Plant(run)
    keep = {k: [] for k in ("x", "U_in", "al_in", "u", "U_out", "al_out", "first")}
    ticks, syncs, launches = [], [], []
    failed = torch.zeros((), dtype=torch.int64, device=run.device)
    episodes = 0
    launches.append(sut.counters().get("fwd_launches"))
    run.window_start()
    done = False
    while not done:
        e = episodes
        at = set(tr.sample(run.seed, e, T, int(ck["ticks_per_episode"]), always=(0,)))
        lanes = torch.as_tensor(tr.sample(run.seed, (1 << 20) + e, B, int(ck["lanes_per_tick"])), device=run.device)
        with span("mpc.reset"):
            state, x = sut.init(B), _x0(run, tr.member(t, run.seed, e))
        for k in range(T):
            rec = k in at
            if rec:
                before = sut.lanes(state, lanes)
                x_in = x.index_select(0, lanes)
            run.sync()
            ta = time.perf_counter()
            with span("mpc.step"):
                u, state, solved = sut.step(state, x)
            with span("mpc.u_to_host"):
                u.cpu()
            tb = time.perf_counter()
            ticks.append(tb - ta)
            c = sut.counters()
            syncs.append(c.get("host_syncs"))
            launches.append(c.get("fwd_launches"))
            if rec:
                after = sut.lanes(state, lanes)
                keep["x"].append(x_in)
                keep["U_in"].append(before["U"])
                keep["al_in"].append(before["al"])
                keep["u"].append(u.index_select(0, lanes))
                keep["U_out"].append(after["U"])
                keep["al_out"].append(after["al"])
                keep["first"].append(torch.full((len(lanes),), k == 0, dtype=torch.bool))
            with span("mpc.plant"):
                x = plant(x, u)
        failed += (~solved).sum()
        episodes += 1
        done = tr.cycle_done(t, e) and time.perf_counter() - run.t_window >= run.seconds
    run.sync()
    end = time.perf_counter()
    run.window.update(ticks=ticks, controllers=B, span_s=end - run.t_window, episodes=episodes)
    run.attempted, run.failed = episodes * B, int(failed)
    per_tick = [b - a for a, b in zip(launches, launches[1:]) if a is not None]
    run.counters.update(host_syncs_per_tick=syncs, fwd_launches_per_tick=per_tick)
    run.records = dict(
        x=torch.cat(keep["x"]), U_in=torch.cat(keep["U_in"]), u=torch.cat(keep["u"]),
        U_out=torch.cat(keep["U_out"]), first=torch.cat(keep["first"]),
        al_in={k: tuple(torch.cat([a[k][i] for a in keep["al_in"]]) for i in (0, 1)) for k in keep["al_in"][0]},
        al_out={k: tuple(torch.cat([a[k][i] for a in keep["al_out"]]) for i in (0, 1)) for k in keep["al_out"][0]},
    )


def trace(run, sut) -> None:
    """`trace_ticks` ticks from the middle of an episode traced over the
    device alone, with their kernels' launches counted, then as many
    traced over host and device, for the names of the idle gaps."""
    t = run.cell.traffic
    plant = Plant(run)
    state, x = sut.init(t["controllers"]), _x0(run, 0)
    for _ in range(int(t.get("trace_after_ticks", 10))):
        u, state, _ = sut.step(state, x)
        x = plant(x, u)

    def ticks(state, x):
        for _ in range(int(t.get("trace_ticks", 3))):
            with span("mpc.step"):
                u, state, _ = sut.step(state, x)
            with span("mpc.u_to_host"):
                u.cpu()
            with span("mpc.plant"):
                x = plant(x, u)
        return state, x

    before = sut.launch_counts()
    out, named = {}, {}
    with traced(out, host=False):
        state, x = ticks(state, x)
    after = sut.launch_counts()
    with traced(named, host=True):
        ticks(state, x)
    run.trace, run.trace_named = out["trace"], named["trace"]
    run.launches = {k: [(w, a - b) for (w, b), (_, a) in zip(before[k], after[k])] for k in after}
