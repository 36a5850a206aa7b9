"""Quadrotor with a unit quaternion (the ALTRO paper's quadrotor, Howell,
Jackson, Manchester, IROS 2019)."""
import torch


def _qmul(q, r):
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dynamics(x, u, params):
    """Quadrotor with a unit quaternion: x = (p 3, q 4 wxyz, v 3 world,
    ω 3 body), u = four rotor thrusts; rotors on the +x, +y, -x, -y arms
    with alternating spin (the ALTRO paper's quadrotor, Howell, Jackson,
    Manchester, IROS 2019)."""
    mass, J, g = params["mass"], params["J"], params["gravity"]
    kf, km, L = params["kf"], params["km"], params["arm_length"]
    q, v, w = x[..., 3:7], x[..., 7:10], x[..., 10:13]
    zero = torch.zeros_like(x[..., 0])
    thrust = torch.stack([zero, zero, kf * u.sum(dim=-1)], dim=-1)
    tau = torch.stack([
        L * kf * (u[..., 1] - u[..., 3]),
        L * kf * (u[..., 2] - u[..., 0]),
        km * (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3]),
    ], dim=-1)
    qdot = 0.5 * _qmul(q, torch.cat([zero[..., None], w], dim=-1))
    qv, qw = q[..., 1:], q[..., :1]
    rotated = thrust + 2.0 * _cross(qv, _cross(qv, thrust) + qw * thrust)
    gvec = torch.stack([zero, zero, zero - g], dim=-1)
    vdot = gvec + rotated / mass
    Jt = torch.as_tensor(J, dtype=x.dtype, device=x.device)
    wdot = (tau - _cross(w, Jt * w)) / Jt
    return torch.cat([v, qdot, vdot, wdot], dim=-1)
