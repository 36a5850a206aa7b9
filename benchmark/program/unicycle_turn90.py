"""The port's turn-90 parking problem: its canned `UnicycleProblem`
(altro-cpp `examples/problems/unicycle.cpp`, kTurn90) at the configured
horizon.  Returns the compiled problem and the initial guess."""


def build(cfg: dict, device, dtype):
    from altro_tpu_torch.models.problems import UnicycleProblem

    defn = UnicycleProblem(dtype=dtype, device=device, N=int(cfg["problem"]["N"]))
    return defn.make_problem().compile(), defn.initial_trajectory()
