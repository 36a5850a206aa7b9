"""The port's zoo quadrotor, hover to hover with bounded thrusts
(`altro_tpu_torch.models.problems.zoo_quadrotor`), at the configured
horizon and final time.  Returns the compiled problem and the initial
guess at hover thrust."""


def build(cfg: dict, device, dtype):
    from altro_tpu_torch.models.problems import zoo_quadrotor

    pb = cfg["problem"]
    prob, Z0, _, _ = zoo_quadrotor(N=int(pb["N"]), tf=float(pb["tf"]), dtype=dtype, device=device)
    return prob, Z0
