"""Kinematic unicycle: x = (px, py, θ), u = (v, ω) (altro-cpp
`examples/problems/unicycle.hpp`)."""
import torch


def dynamics(x, u, params=None):
    th, v, w = x[..., 2], u[..., 0], u[..., 1]
    return torch.stack([v * torch.cos(th), v * torch.sin(th), w], dim=-1)
