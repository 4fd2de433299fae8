"""Continuous-adjoint backward pass for the fixed-step path integrator.

Port of ``xnode_wan_tpu/ops/adjoint.py``: the reference's torchdiffeq
``odeint_adjoint`` (``src/model.py:8,103``). Instead of differentiating
through the solver's steps, the backward integrates the adjoint ODE
backward in time (Chen et al. 2018),

    dh/dt       = f(t, h)
    dlambda/dt  = -lambda^T df/dh
    dg_theta/dt = -lambda^T df/dtheta,

rebuilding ``h`` on the way: O(1) activations in the number of steps, at
the price of one more integration's field evaluations and of gradients
that are exact only up to the discretization error.

One reverse loop over the ``L`` sample intervals; within each, the
augmented system runs backward with the forward's fixed-step scheme on a
per-row unit-time parametrization (``tau in [0, 1]``, a scalar substep:
each row's ``dt`` folds into the dynamics, so the parameter cotangent
takes each row's quadrature weight from one ``torch.func.vjp`` of the
field a stage). The sample states ``hs[l]`` come from the forward's
output, so a reconstruction spans one interval and cannot drift.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from xnode_wan_tpu_torch.ops.integrate import integrate
from xnode_wan_tpu_torch.ops.kernels.steppers import FUSED_KERNEL_METHODS

# field_fn(params, xs, t, h) -> dh/dt, batched over rows: params a tuple of
# tensors, xs [N, F] frozen spatial features, t [N], h [N, H]
FieldFn = Callable


def _axpy(a: float, x: Sequence[torch.Tensor], y: Sequence[torch.Tensor]):
    """``y + a * x`` over matching tuples of tensors (``a`` a scalar)."""
    return tuple(yi + a * xi for xi, yi in zip(x, y))


def _rk_tree_step(method: str, G, tau: float, S, dtau: float):
    """One fixed step of ``method`` on the tuple state ``S`` with the
    scalar step ``dtau`` (the unit-time parametrization makes the step
    scalar although each row's ``dt`` differs)."""
    if method == "euler":
        return _axpy(dtau, G(tau, S), S)
    if method == "midpoint":
        k1 = G(tau, S)
        return _axpy(dtau, G(tau + 0.5 * dtau, _axpy(0.5 * dtau, k1, S)), S)
    if method == "heun":
        k1 = G(tau, S)
        k2 = G(tau + dtau, _axpy(dtau, k1, S))
        return _axpy(dtau, tuple(0.5 * (a + b) for a, b in zip(k1, k2)), S)
    if method == "rk4":
        k1 = G(tau, S)
        k2 = G(tau + 0.5 * dtau, _axpy(0.5 * dtau, k1, S))
        k3 = G(tau + 0.5 * dtau, _axpy(0.5 * dtau, k2, S))
        k4 = G(tau + dtau, _axpy(dtau, k3, S))
        return _axpy(dtau, tuple((a + 2 * b + 2 * c + d) / 6.0
                                 for a, b, c, d in zip(k1, k2, k3, k4)), S)
    raise ValueError(
        f"continuous adjoint supports the RK fixed-step methods "
        f"{FUSED_KERNEL_METHODS}, not {method!r}: multistep history does "
        "not transfer to the backward-in-time augmented system")


class _Adjoint(torch.autograd.Function):
    """Forward: :func:`integrate`. Backward: the reverse interval loop."""

    @staticmethod
    def forward(ctx, field_fn, n_sub, method, xs, h0, times, t_start, mask,
                *params):
        if ctx.needs_input_grad[5] or ctx.needs_input_grad[6]:
            raise ValueError(
                "the continuous adjoint gives no gradient of the sample "
                "times or t_start (they are quadrature nodes): pass them "
                "without requires_grad")
        hs = integrate(lambda t, h: field_fn(params, xs, t, h), h0, times,
                       t_start, mask, n_sub=n_sub, method=method)
        ctx.save_for_backward(xs, hs, times, t_start, mask, *params)
        ctx.field_fn, ctx.n_sub, ctx.method = field_fn, n_sub, method
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        xs, hs, times, t_start, mask, *params = ctx.saved_tensors
        params = tuple(params)
        field_fn, n_sub, method = ctx.field_fn, ctx.n_sub, ctx.method
        L = times.shape[1]
        # each sample's previous valid time (the forward's t_prev there):
        # t_start before the first valid sample
        prev, t_prev = t_start.to(hs.dtype), []
        for l in range(L):
            t_prev.append(prev)
            prev = torch.where(mask[:, l], times[:, l], prev)

        lam = torch.zeros_like(hs[:, 0])
        g_xs = torch.zeros_like(xs)
        g_params = tuple(torch.zeros_like(p) for p in params)
        dtau = 1.0 / n_sub
        for l in reversed(range(L)):
            m_l = mask[:, l]
            # the cotangent of output l joins lambda at its sample
            lam = lam + g_hs[:, l]
            # masked rows may hold garbage (even NaN) times: dt_row = 0
            # makes their integration a no-op, but the field would still
            # see the time, and 0 * NaN would poison the row-summed
            # parameter cotangent, so the time is cleaned first
            t_l = torch.where(m_l, times[:, l], 0.0)
            dt_row = torch.where(m_l, torch.clamp(t_l - t_prev[l], min=0.0),
                                 0.0)

            def G(tau, S, t_l=t_l, dt_row=dt_row):
                h, lam_s = S[0], S[1]
                t = t_l - tau * dt_row                           # [N]
                f_val, vjp_fn = torch.func.vjp(
                    lambda p, xx, hh: field_fn(p, xx, t, hh), params, xs, h)
                # the row's dt in the cotangent scales lambda's dynamics
                # and gives the parameter and feature cotangents the row's
                # quadrature weight
                gp_d, gx_d, gh = vjp_fn(lam_s * dt_row[:, None])
                return (-dt_row[:, None] * f_val, gh, gx_d, *gp_d)

            S = (hs[:, l], lam, g_xs, *g_params)
            for k in range(n_sub):
                S = _rk_tree_step(method, G, k * dtau, S, dtau)
            # dt_row == 0 makes the invalid rows a no-op; the select keeps
            # them exact under non-finite garbage times
            lam = torch.where(m_l[:, None], S[1], lam)
            g_xs, g_params = S[2], S[3:]
        return (None, None, None, g_xs, lam, None, None, None, *g_params)


def make_adjoint_integrator(field_fn: FieldFn, n_sub: int, method: str):
    """``run(params, xs, h0, times, t_start, mask) -> hs`` whose backward
    is the continuous adjoint above; ``params`` is a tuple of tensors.

    The forward is :func:`ops.integrate.integrate` (same stepper, same
    masked scan), value for value; only the derivative differs.
    Cotangents go to ``params``, ``xs`` and ``h0``. The sample times and
    ``t_start`` are quadrature nodes: where a gradient of either is asked
    for, ``run`` raises (the JAX package returns zeros there).
    """
    if method not in FUSED_KERNEL_METHODS:
        raise ValueError(f"continuous adjoint supports {FUSED_KERNEL_METHODS}"
                         f", not {method!r}")

    def run(params, xs, h0, times, t_start, mask):
        return _Adjoint.apply(field_fn, n_sub, method, xs, h0, times,
                              t_start, mask, *params)
    return run
