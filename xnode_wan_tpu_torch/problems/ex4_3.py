"""Paper example 4.3: dim-generic product-of-sines problem
(reference ``configs/Ex4_3_funcs.py``; JAX ``xnode_wan_tpu/problems/ex4_3.py``).

``u = (2/pi)^{-d} 2 prod_i sin(pi/2 x_i + pi/2 i) e^{-t}`` with ``a = I``,
``b = 0``, ``c(X, u) = -u``. The reference module reads the dimension through
a broken ``from NODE_GAN.main import params`` import (``:3``); here it is an
explicit factory argument.

Note: the reference's ``func_f`` is kept verbatim; its Laplacian prefactor
``(pi^2 - 2)`` only matches the PDE at d = 2 (and the nonlinear term drops
the ``(2/pi)^{-d}`` scaling squared), faithful to ``configs/Ex4_3_funcs.py:13-17``.
"""

from __future__ import annotations

import math

import torch

from xnode_wan_tpu_torch.problems import Problem

_HALF_PI = math.pi / 2


def _sins(X, dim: int):
    s = 1.0
    for i in range(dim):
        s = s * torch.sin(_HALF_PI * X[..., i + 1] + _HALF_PI * i)
    return s


def get_problem(dim: int | None, consistent: bool = False) -> Problem:
    """``consistent=True`` replaces the reference's source term with the one
    actually implied by the PDE: for ``u = K 2 prod sin e^{-t}`` with
    ``a = I``, ``b = 0``, ``c u = -u^2``,

        f = u_t - Lap(u) - u^2 = (d pi^2/4 - 1) u - u^2.

    The reference's literal ``f`` never zeroes the residual (its linear
    term only matches at d=2 and its nonlinear term drops the
    ``(2/pi)^{-2d}`` scaling at every dim), so relative error against
    ``u_sol`` cannot converge under it. Use the consistent variant for real
    runs (``Ex4_3_consistent`` in the CLI).
    """
    if dim is None:
        raise ValueError("ex4_3 needs an explicit spatial dimension")
    scale = (2.0 / math.pi) ** (-dim)

    def u_sol(X):
        return scale * 2.0 * _sins(X, dim) * torch.exp(-X[..., 0])

    if consistent:
        def f(X):
            u = u_sol(X)
            return (dim * math.pi ** 2 / 4.0 - 1.0) * u - u ** 2
    else:
        def f(X):
            s = _sins(X, dim)
            return (scale * (math.pi ** 2 - 2.0) * s * torch.exp(-X[..., 0])
                    - 4.0 * s ** 2 * torch.exp(-2.0 * X[..., 0]))

    def g(X):
        return u_sol(X)

    def h(X):
        return scale * 2.0 * _sins(X, dim)

    def c(X, u):
        return -u

    return Problem(
        name=f"ex4_3_d{dim}" + ("_consistent" if consistent else ""),
        h=h, f=f, g=g, c=c,
        a_kind="isotropic", b=None,
        u_sol=u_sol, dim=dim,
    )


def get_problem_consistent(dim: int | None) -> Problem:
    return get_problem(dim, consistent=True)
