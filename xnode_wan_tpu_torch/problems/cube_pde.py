"""The paper's d=5 hypercube test problem (reference ``configs/cube_pde_funcs.py``).

Exact solution ``u = 2 sin(pi/2 x_1) cos(pi/2 x_2) e^{-t}`` of
``u_t - Lap(u) - u^2 = f`` on ``[-1, 1]^d x [0, 1]`` with ``a = I``,
``b = 0``, nonlinear reaction ``c(X, u) = -u``.
"""

from __future__ import annotations

import math

import torch

from xnode_wan_tpu_torch.problems import Problem

_HALF_PI = math.pi / 2


def u_sol(X):
    return (2.0 * torch.sin(_HALF_PI * X[..., 1])
            * torch.cos(_HALF_PI * X[..., 2]) * torch.exp(-X[..., 0]))


def f(X):
    sincos = torch.sin(_HALF_PI * X[..., 1]) * torch.cos(_HALF_PI * X[..., 2])
    return ((math.pi ** 2 - 2.0) * sincos * torch.exp(-X[..., 0])
            - 4.0 * sincos ** 2 * torch.exp(-2.0 * X[..., 0]))


def g(X):
    return u_sol(X)


def h(X):
    # u_sol at t = T0 = 0; takes the full (t, x) point like the reference.
    return 2.0 * torch.sin(_HALF_PI * X[..., 1]) * torch.cos(_HALF_PI * X[..., 2])


def c(X, u):
    return -u


PROBLEM = Problem(
    name="cube_pde",
    h=h, f=f, g=g, c=c,
    a_kind="isotropic",
    b=None,
    u_sol=u_sol,
)


def get_problem(dim=None):
    del dim  # the solution only involves x_1, x_2: any dim >= 2 works
    return PROBLEM
