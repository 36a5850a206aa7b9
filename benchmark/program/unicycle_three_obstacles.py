"""The port's three-obstacle unicycle problem: its canned `UnicycleProblem`
(altro-cpp `examples/problems/unicycle.cpp`, kThreeObstacles) at the
configured horizon.  Returns the compiled problem and the initial guess."""


def build(cfg: dict, device, dtype):
    from altro_tpu_torch.models.problems import THREE_OBSTACLES, UnicycleProblem

    defn = UnicycleProblem(scenario=THREE_OBSTACLES, dtype=dtype, device=device, N=int(cfg["problem"]["N"]))
    return defn.make_problem().compile(), defn.initial_trajectory()
