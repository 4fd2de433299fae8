"""ODE integration along path time grids, with masking.

Port of ``xnode_wan_tpu/ops/integrate.py``: a loop over the ``L`` sample
times; each interval ``[t_prev, t_l]`` is integrated by

* :func:`integrate`: ``n_sub`` equal substeps of euler, midpoint, heun or
  rk4 (the step bodies the kernels' plain versions use,
  ``ops/kernels/steppers.py::rk_step``), or of the fixed-step Adams
  multisteps ``explicit_adams`` / ``fixed_adams``, whose history restarts
  at each sample interval;
* :func:`integrate_adaptive`: an embedded Runge-Kutta pair (dopri5,
  bosh3, adaptive_heun, fehlberg2, dopri8) or the variable-coefficient
  Adams-Bashforth-Moulton ``adams`` (VCABM), with per-path step sizes
  under a detached accept/step controller and at most ``max_steps``
  attempts per interval.

Invalid samples leave the carried state untouched, and ``dt`` is clamped
at 0. ``remat=True`` recomputes each sample interval in the backward
(the JAX package's ``jax.checkpoint`` of the scan step): the values stay
the same, only the backward's memory changes.

An adaptive interval stops its attempts once no path is active: an idle
attempt leaves every carry bitwise unchanged, so the values are those of
the JAX package's full ``max_steps`` loop. A recomputed interval repeats
the count of its first run.

A :class:`Jet` start state carries D tangent directions through any of
these integrators beside the state (the XNODE's u side: remat cannot run
inside ``torch.func.jvp``, so the recomputed interval maps ``(h, dh[D])
-> (h', dh'[D])`` itself, with the field's forward-mode derivative
written out).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Dict

import torch

from xnode_wan_tpu_torch.ops.kernels.steppers import (FUSED_KERNEL_METHODS,
                                                      rk_step)

Field = Callable  # (t [N], h [N, H]) -> dh/dt, on tensors or Jets

MULTISTEP_METHODS = ("explicit_adams", "fixed_adams")
FIXED_METHODS = FUSED_KERNEL_METHODS + MULTISTEP_METHODS
ADAPTIVE_METHODS = ("dopri5", "bosh3", "adaptive_heun", "fehlberg2",
                    "dopri8", "adams")

# Adams-Bashforth / Adams-Moulton coefficients on a uniform substep grid,
# per history length (most recent function value first): ``explicit_adams``
# is AB4 with an order ramp at startup, ``fixed_adams`` AB4-predict /
# AM4-correct (PECE), as torchdiffeq's fixed-grid multisteps.
_AB = {
    1: (1.0,),
    2: (3 / 2, -1 / 2),
    3: (23 / 12, -16 / 12, 5 / 12),
    4: (55 / 24, -59 / 24, 37 / 24, -9 / 24),
}
_AM = {  # the first coefficient multiplies f(t_{k+1}, h_predicted)
    1: (1.0,),
    2: (1 / 2, 1 / 2),
    3: (5 / 12, 8 / 12, -1 / 12),
    4: (9 / 24, 19 / 24, -5 / 24, 1 / 24),
}

# Embedded Runge-Kutta tableaus: (c nodes, A rows, b_high, b_low, the
# error order; the step controller's exponent is 1/order). dopri5 is
# Dormand-Prince 5(4), torchdiffeq's default adaptive method; bosh3
# Bogacki-Shampine 3(2); adaptive_heun the Heun-Euler 2(1) pair; fehlberg2
# Fehlberg's RK2(1); dopri8 (added below) Hairer's 12-stage 8(5) pair.
_TABLEAUS = {
    "dopri5": (
        (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
        (
            (),
            (1 / 5,),
            (3 / 40, 9 / 40),
            (44 / 45, -56 / 15, 32 / 9),
            (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
            (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
            (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
        ),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
        (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
         187 / 2100, 1 / 40),
        5,
    ),
    "bosh3": (
        (0.0, 1 / 2, 3 / 4, 1.0),
        ((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
        (2 / 9, 1 / 3, 4 / 9, 0.0),
        (7 / 24, 1 / 4, 1 / 3, 1 / 8),
        3,
    ),
    "adaptive_heun": (
        (0.0, 1.0),
        ((), (1.0,)),
        (1 / 2, 1 / 2),
        (1.0, 0.0),
        2,
    ),
    "fehlberg2": (
        (0.0, 1 / 2, 1.0),
        ((), (1 / 2,), (1 / 256, 255 / 256)),
        (1 / 512, 255 / 256, 1 / 512),
        (1 / 256, 255 / 256, 0.0),
        2,
    ),
}

# Hairer's DOP853 coefficients at full f64 precision (the JAX package's
# literals, generated from scipy.integrate._ivp.dop853_coefficients).
_DOP853_C = (
    0.0, 0.05260015195876773, 0.0789002279381516, 0.1183503419072274,
    0.2816496580927726, 0.3333333333333333, 0.25, 0.3076923076923077,
    0.6512820512820513, 0.6, 0.8571428571428571, 1.0,
)
_DOP853_A = (
    (),
    (0.05260015195876773,),
    (0.0197250569845379, 0.0591751709536137),
    (0.02958758547680685, 0.0, 0.08876275643042054),
    (0.2413651341592667, 0.0, -0.8845494793282861, 0.924834003261792),
    (0.037037037037037035, 0.0, 0.0, 0.17082860872947386,
     0.12546768756682242),
    (0.037109375, 0.0, 0.0, 0.17025221101954405, 0.06021653898045596,
     -0.017578125),
    (0.03709200011850479, 0.0, 0.0, 0.17038392571223998,
     0.10726203044637328, -0.015319437748624402, 0.008273789163814023),
    (0.6241109587160757, 0.0, 0.0, -3.3608926294469414, -0.868219346841726,
     27.59209969944671, 20.154067550477894, -43.48988418106996),
    (0.47766253643826434, 0.0, 0.0, -2.4881146199716677, -0.590290826836843,
     21.230051448181193, 15.279233632882423, -33.28821096898486,
     -0.020331201708508627),
    (-0.9371424300859873, 0.0, 0.0, 5.186372428844064, 1.0914373489967295,
     -8.149787010746927, -18.52006565999696, 22.739487099350505,
     2.4936055526796523, -3.0467644718982196),
    (2.273310147516538, 0.0, 0.0, -10.53449546673725, -2.0008720582248625,
     -17.9589318631188, 27.94888452941996, -2.8589982771350235,
     -8.87285693353063, 12.360567175794303, 0.6433927460157636),
)
_DOP853_B = (
    0.054293734116568765, 0.0, 0.0, 0.0, 0.0, 4.450312892752409,
    1.8915178993145003, -5.801203960010585, 0.3111643669578199,
    -0.1521609496625161, 0.20136540080403034, 0.04471061572777259,
)
_DOP853_E5 = (
    0.01312004499419488, 0.0, 0.0, 0.0, 0.0, -1.2251564463762044,
    -0.4957589496572502, 1.6643771824549864, -0.35032884874997366,
    0.3341791187130175, 0.08192320648511571, -0.022355307863886294,
)


def _dop853_tableau():
    """torchdiffeq's ``dopri8``: the 12 DOP853 stages and 8th-order
    weights ``B``, with ``B - E5`` (the 5th-order error row) as the
    embedded solution; error ~ O(h^6), so controller order 6."""
    b_lo = tuple(b - e for b, e in zip(_DOP853_B, _DOP853_E5))
    return _DOP853_C, _DOP853_A, _DOP853_B, b_lo, 6


_TABLEAUS["dopri8"] = _dop853_tableau()


def _tableau(method: str):
    if method not in _TABLEAUS:
        raise ValueError(f"no embedded Runge-Kutta pair {method!r}")
    return _TABLEAUS[method]


def check_method(method: str) -> None:
    """Raise for an integration method the port does not know."""
    if method not in FIXED_METHODS and method not in ADAPTIVE_METHODS:
        raise ValueError(f"unknown method {method!r}; valid: "
                         f"{FIXED_METHODS + ADAPTIVE_METHODS}")


# ---------------------------------------------------------------------------
# states with tangents, and the scan

class Jet:
    """A state ``p [N, ...]`` with D tangent directions ``t [D, N, ...]``.

    The integrators are linear in the state apart from the field, so a
    Jet goes through them as a tensor does: ``+``, ``-``, products with
    tensors or numbers that carry no tangent (the steps, coefficients and
    masks), and :func:`_lin` for slicing and the like. The field takes
    and returns Jets (``models/xnode.py::field_jvp``). Every operation on
    ``p`` is the one the plain state takes, so its values are the plain
    integrator's; the controller reads ``p`` only (:func:`_p`)."""

    __slots__ = ("p", "t")

    def __init__(self, p: torch.Tensor, t: torch.Tensor):
        self.p, self.t = p, t

    def __add__(self, o):
        if isinstance(o, Jet):
            return Jet(self.p + o.p, self.t + o.t)
        return Jet(self.p + o, self.t)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Jet):
            return Jet(self.p - o.p, self.t - o.t)
        return Jet(self.p - o, self.t)

    def __mul__(self, c):
        return Jet(self.p * c, self.t * c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        return Jet(self.p / c, self.t / c)


def _p(x):
    """The primal of a state."""
    return x.p if isinstance(x, Jet) else x


def _lin(fn, x):
    """A linear map ``fn`` (written for any leading axes) on a state."""
    return Jet(fn(x.p), fn(x.t)) if isinstance(x, Jet) else fn(x)


def _where(c: torch.Tensor, a, b):
    """``torch.where`` on states; ``c`` broadcasts from the right."""
    if isinstance(a, Jet):
        return Jet(torch.where(c, a.p, b.p), torch.where(c, a.t, b.t))
    return torch.where(c, a, b)


def _poison(c: torch.Tensor, x):
    """NaN where ``c`` holds; a tangent there is 0, as JAX's jvp of
    ``where(c, nan, x)`` gives."""
    if isinstance(x, Jet):
        return Jet(torch.where(c, torch.nan, x.p), torch.where(c, 0.0, x.t))
    return torch.where(c, torch.nan, x)


def _rows(m: torch.Tensor, x) -> torch.Tensor:
    """The per-path flags ``m [N]`` shaped to broadcast against ``x``."""
    return m.reshape(m.shape + (1,) * (_p(x).dim() - 1))


def _select_all(m, new, old):
    """Per path: the rows where ``m [N]`` holds take ``new``."""
    return tuple(_where(_rows(m, a), a, b) for a, b in zip(new, old))


def _stack(xs):
    """Sample states ``[N, H]`` (tangents ``[D, N, H]``) -> ``[N, L, H]``."""
    if isinstance(xs[0], Jet):
        return Jet(torch.stack([x.p for x in xs], dim=-2),
                   torch.stack([x.t for x in xs], dim=-2))
    return torch.stack(xs, dim=1)


def _flatten(carry):
    """A carry of tensors and Jets as a flat list, and how to rebuild it."""
    flat, spec = [], []
    for x in carry:
        flat.extend((x.p, x.t) if isinstance(x, Jet) else (x,))
        spec.append(isinstance(x, Jet))
    return flat, spec


def _unflatten(flat, spec):
    out, i = [], 0
    for jet in spec:
        out.append(Jet(flat[i], flat[i + 1]) if jet else flat[i])
        i += 2 if jet else 1
    return tuple(out)


class _Recompute(torch.autograd.Function):
    """One sample interval run without storing its activations (the JAX
    package's ``jax.checkpoint`` of the scan step): the forward runs
    without a graph, the backward runs it again with one and takes the
    gradients of its inputs and of ``closed``, the tensors the field
    closes over (its parameters), which come in as inputs so that their
    gradients are returned. (``torch.utils.checkpoint`` finds such
    tensors itself, at a Python hook for every saved tensor, which cost
    the H100's host more than the recompute.)"""

    @staticmethod
    def forward(ctx, run, states, n_carry, *tensors):
        ctx.run, ctx.n_carry = run, n_carry
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            flat = _flatten(run(*tensors[:n_carry + 2]))[0]
        # the step controller's outputs (times, steps, orders) carry none
        ctx.mark_non_differentiable(
            *(o for o, st in zip(flat, states) if not st))
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        n = ctx.n_carry
        carry = [t.detach().requires_grad_(t.requires_grad)
                 for t in tensors[:n]]
        with torch.enable_grad():
            outs, _ = _flatten(ctx.run(*carry, *tensors[n:n + 2]))
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [(i, t) for i, t in enumerate(carry + list(tensors[n + 2:]))
               if t.requires_grad]
        found = torch.autograd.grad(
            [o for o, _ in pairs], [t for _, t in wrt],
            [g for _, g in pairs], allow_unused=True) if pairs and wrt else ()
        result = [None] * (len(tensors))
        for (i, _), g in zip(wrt, found):
            result[i if i < n else i + 2] = g
        return (None, None, None, *result)


def _scan(interval, carry, times, mask, remat: bool, closed=None,
          states=(0,)):
    """``interval(carry, t_l, m_l, l) -> carry`` over the L sample times;
    under ``remat``, when gradients are enabled, each interval is
    recomputed in the backward instead of storing its activations
    (:class:`_Recompute`; ``closed`` must list every tensor the field
    closes over that needs a gradient, ``states`` the carry's positions
    that can have one). Returns the stacked ``carry[0]`` of every
    sample."""
    hs = []
    ckpt = remat and torch.is_grad_enabled()
    if ckpt and closed is None:
        raise ValueError(
            "remat recomputes each interval in the backward: pass closed=, "
            "every tensor the field closes over that needs a gradient")
    for l in range(times.shape[1]):
        if ckpt:
            flat, spec = _flatten(carry)
            diff = [i in states for i, jet in enumerate(spec)
                    for _ in range(2 if jet else 1)]

            def run(*xs, spec=spec, l=l):
                return interval(_unflatten(xs[:-2], spec), *xs[-2:], l)
            carry = _unflatten(_Recompute.apply(
                run, diff, len(flat), *flat, times[:, l], mask[:, l],
                *closed), spec)
        else:
            carry = interval(carry, times[:, l], mask[:, l], l)
        hs.append(carry[0])
    return _stack(hs)


def _attempts(body, carry, t1: torch.Tensor, max_steps: int,
              record: Dict[int, int], key: int):
    """Up to ``max_steps`` attempts ``carry = body(carry)`` (``carry[1]``
    is each path's time), stopping once no path is active;
    ``record[key]`` keeps the count, which a recompute repeats."""
    limit = record.get(key)
    n = 0
    while n < (max_steps if limit is None else limit):
        if limit is None and not bool((carry[1] < t1 - 1e-12).any()):
            break
        carry = body(carry)
        n += 1
    record[key] = n
    return carry


def _any(flags: torch.Tensor, record: Dict[int, int], key: int) -> bool:
    """Whether any of ``flags`` holds, kept in ``record[key]`` for a
    recompute as :func:`_attempts` keeps its count."""
    if key not in record:
        record[key] = int(bool(flags.any()))
    return bool(record[key])


# ---------------------------------------------------------------------------
# fixed steps

def _fixed_interval(field: Field, method: str, n_sub: int, h, t0, t1):
    """One sample interval of a fixed-step scheme."""
    dt = (torch.clamp(t1 - t0, min=0.0) / n_sub)[:, None]
    if method in MULTISTEP_METHODS:
        correct = method == "fixed_adams"
        hist = []  # f evaluations, oldest first (uniform dt)
        for k in range(n_sub):
            t = t0 + k * dt[:, 0]
            hist.append(field(t, h))
            m = min(len(hist), 4)
            recent = hist[::-1][:m]
            inc = sum(c * f for c, f in zip(_AB[m], recent))
            h_pred = h + dt * inc
            if correct:
                f_new = field(t + dt[:, 0], h_pred)
                mc = min(len(hist) + 1, 4)
                cc = _AM[mc]
                inc = cc[0] * f_new + sum(
                    c * f for c, f in zip(cc[1:], recent[:mc - 1]))
                h = h + dt * inc
            else:
                h = h_pred
        return h

    def field_col(t, h):  # rk_step's times are columns [N, 1]
        return field(t[:, 0], h)

    for k in range(n_sub):
        h = rk_step(method, field_col, (t0 + k * dt[:, 0])[:, None], dt, h)
    return h


def _run_fixed(field, h0, times, t_start, mask, n_sub, method, remat,
               closed):
    def interval(carry, t_l, m_l, l):
        h, t_prev = carry
        h_new = _fixed_interval(field, method, n_sub, h, t_prev, t_l)
        return (_where(_rows(m_l, h), h_new, h),
                torch.where(m_l, t_l, t_prev))

    return _scan(interval, (h0, t_start.to(_p(h0).dtype)), times, mask,
                 remat, closed)


# ---------------------------------------------------------------------------
# embedded Runge-Kutta pairs

def _weights(coefs, dtype, device):
    """A tableau row as ``(indices, weights)`` over its nonzero entries:
    the weights a tensor when there are several, else a float."""
    idx = [j for j, c in enumerate(coefs) if c != 0.0]
    if len(idx) == 1:
        return idx, coefs[idx[0]]
    return idx, torch.tensor([coefs[j] for j in idx], dtype=dtype,
                             device=device)


def _combine(row, ks):
    """``sum_j w_j ks[j]`` over a row of :func:`_weights` (tensors or
    Jets): one stacked product when there are several terms."""
    idx, w = row
    if not torch.is_tensor(w):
        return w * ks[idx[0]]

    def dot(xs):
        return torch.tensordot(w, torch.stack(xs), dims=1)
    if isinstance(ks[0], Jet):
        return Jet(dot([ks[j].p for j in idx]), dot([ks[j].t for j in idx]))
    return dot([ks[j] for j in idx])


def _prepared(tableau, dtype, device):
    """The tableau's nodes, its rows, its high-order weights and its error
    weights as :func:`_weights` (rows without a nonzero entry None)."""
    cs, rows, b_hi, b_lo, _ = tableau
    return (cs, [_weights(r, dtype, device) if any(r) else None
                 for r in rows],
            _weights(b_hi, dtype, device),
            _weights([bh - bl for bh, bl in zip(b_hi, b_lo)], dtype, device))


def _embedded_step(prepared, field: Field, t, h, dt):
    """One embedded RK step over a :func:`_prepared` tableau; returns
    ``(h_high, error_estimate)``, the estimate of the primal only."""
    cs, rows, b_hi, b_err = prepared
    ks = []
    for c, row in zip(cs, rows):
        hk = h if row is None else h + dt * _combine(row, ks)
        ks.append(field(t + c * dt[:, 0], hk))
    return (h + dt * _combine(b_hi, ks),
            dt * _combine(b_err, [_p(k) for k in ks]))


def _run_embedded(field, h0, times, t_start, mask, rtol, atol, max_steps,
                  strict, method, remat, closed):
    tableau = _tableau(method)
    inv_order = 1.0 / tableau[4]
    prepared = _prepared(tableau, _p(h0).dtype, _p(h0).device)
    record: Dict[int, int] = {}

    def interval(carry, t_l, m_l, l):
        h, t_prev = carry
        t1 = torch.where(m_l, torch.maximum(t_l, t_prev), t_prev)
        span = torch.clamp(t1 - t_prev, min=0.0)          # [N]

        def attempt(c):
            h, t, dt = c
            active = t < t1 - 1e-12
            dt_eff = torch.clamp(torch.minimum(torch.where(active, dt, 0.0),
                                               t1 - t), min=0.0)
            h_new, err = _embedded_step(prepared, field, t, h, dt_eff[:, None])
            # the accept/step-size controller is a discrete decision:
            # detached (discretize-then-optimize), so the backward sees
            # fixed accepted steps and no sqrt'(0) on idle paths
            hp, np_ = _p(h).detach(), _p(h_new).detach()
            tol = atol + rtol * torch.maximum(hp.abs(), np_.abs())
            ratio = torch.sqrt(torch.mean((err.detach() / tol) ** 2, dim=-1))
            accept = (ratio <= 1.0) & active
            fac = torch.clamp(0.9 * (ratio + 1e-12) ** -inv_order, 0.2, 5.0)
            return (_where(accept[:, None], h_new, h),
                    torch.where(accept, t + dt_eff, t),
                    torch.where(active, torch.maximum(dt_eff * fac,
                                                      span / 1e4), dt))

        h_i, t, _ = _attempts(attempt, (h, t_prev, span / 4.0), t1,
                              max_steps, record, l)
        # a path that used up max_steps: NaN under ode_strict (the analogue
        # of torchdiffeq's max_num_steps error), else one forced
        # error-unchecked step over the rest of the interval
        left = torch.clamp(t1 - t, min=0.0)
        exhausted = left > 1e-12
        if _any(exhausted, record, -1 - l):
            if strict:
                h_i = _poison(exhausted[:, None], h_i)
            else:
                h_last, _ = _embedded_step(prepared, field, t, h_i,
                                           left[:, None])
                h_i = _where(exhausted[:, None], h_last, h_i)
        return (_where(_rows(m_l, h), h_i, h),
                torch.where(m_l, t1, t_prev))

    return _scan(interval, (h0, t_start.to(_p(h0).dtype)), times, mask,
                 remat, closed)


# ---------------------------------------------------------------------------
# VCABM ``adams``: variable-coefficient Adams-Bashforth-Moulton after
# Shampine and Gordon, torchdiffeq's ``adams``. PE(CE): a divided-difference
# Adams-Bashforth predictor of the current order, one Adams-Moulton
# corrector in modified-divided-difference form, a second evaluation to
# refresh the difference table, with per-step error control and order
# selection. Per path: every controller scalar is an [N] tensor, the
# difference table phi a static [N, K+1, H] buffer (entries beyond a
# path's order kept exactly zero).

_VCABM_MAX_ORDER = 12   # torchdiffeq's cap; the order adapts in [1, 12)


def _gamma_star(n: int):
    """The first ``n`` Adams-Moulton gamma* coefficients, exact:
    ``gamma*_0 = 1``, ``gamma*_k = -sum_{j<k} gamma*_j / (k + 1 - j)``."""
    gs = [Fraction(1)]
    for k in range(1, n):
        gs.append(-sum(g / (k + 1 - j) for j, g in enumerate(gs)))
    return tuple(float(g) for g in gs)


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > 1e-30, x, 1.0)


def _vcabm_coeffs(tprev: torch.Tensor, next_t: torch.Tensor):
    """Variable-step Adams coefficients ``g [N, K+1]`` and ``beta [N, K]``
    from the accepted step times (Hairer III.5.9), to full static width
    with safe denominators (entries at ``j >= order`` are finite garbage,
    met only by zero ``phi`` rows or masks). Detached: they depend on the
    time history only."""
    K = _VCABM_MAX_ORDER
    tprev, next_t = tprev.detach(), next_t.detach()
    t0 = tprev[:, 0]
    # beta_j = prod_{i<j} (t_{n+1} - t_{n-i}) / (t_n - t_{n-1-i}), 1 on a
    # uniform grid
    ratios = ((next_t[:, None] - tprev[:, :K - 1])
              / _safe(t0[:, None] - tprev[:, 1:]))
    beta = torch.cumprod(torch.cat([torch.ones_like(ratios[:, :1]), ratios],
                                   dim=1), dim=1)             # [N, K]
    facs = (next_t - t0)[:, None] / _safe(next_t[:, None] - tprev)
    c = (1.0 / torch.arange(1, K + 2, dtype=t0.dtype, device=t0.device)
         ).expand(t0.shape[0], K + 1)
    g_list = [torch.ones_like(t0)]
    for j in range(1, K + 1):
        c = c[:, :-1] - (c[:, 1:] if j == 1 else c[:, 1:] * facs[:, j - 1:j])
        g_list.append(c[:, 0])
    return torch.stack(g_list, dim=1), beta               # [N, K+1]


def _take1(a, idx):                                        # [N,W],[N] -> [N]
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _takeh(a, idx):                          # [..., N, W, H] -> [..., N, H]
    def take(x):
        ix = idx[:, None, None].expand(x.shape[:-2] + (1, x.shape[-1]))
        return torch.gather(x, -2, ix)[..., 0, :]
    return _lin(take, a)


def _run_vcabm(field, h0, times, t_start, mask, rtol, atol, max_steps,
               strict, remat, closed):
    """VCABM along each path's sample grid: bounded attempts per interval,
    masked start and exit, steps clamped to land on the sample times.
    The difference table, time history, order and step size carry across
    intervals: the carry is ``(h, t, dt, order, nhist, tprev, phi)``."""
    K = _VCABM_MAX_ORDER
    hp0 = _p(h0)
    dtype, dev = hp0.dtype, hp0.device
    n = hp0.shape[0]
    gs_tab = torch.tensor(_gamma_star(K + 2), dtype=dtype,
                          device=dev).expand(n, K + 2)
    jidx = torch.arange(K + 1, device=dev)
    back = torch.arange(K, dtype=dtype, device=dev)
    record: Dict[int, int] = {}

    def ratio(le, tol):
        return torch.sqrt(torch.mean((le / tol) ** 2, dim=-1))

    def fresh_table(f):
        """``phi`` with ``f`` in row 0 and zeros above."""
        return _lin(lambda a: torch.cat(
            [a[..., None, :], a.new_zeros(a.shape[:-1] + (K,) + a.shape[-1:])],
            dim=-2), f)

    def interval(carry, t_l, m_l, l):
        t = carry[1]
        t1 = torch.where(m_l, torch.maximum(t_l, t), t)
        span = torch.clamp(t1 - t, min=0.0)

        def attempt(c):
            h, t, dt, order, nhist, tprev, phi = c
            active = t < t1 - 1e-12
            # lazy per-path start: the first attempt of the first nonzero
            # interval takes span/8 (order 1)
            dt = torch.where((dt <= 0) & active,
                             torch.clamp(span, min=1e-12) / 8.0, dt)
            dt_eff = torch.clamp(torch.minimum(torch.where(active, dt, 0.0),
                                               t1 - t), min=0.0)
            next_t = t + dt_eff
            g, beta = _vcabm_coeffs(tprev, next_t)
            gpm = g[:, :K] * (jidx[None, :K] < order[:, None]).to(dtype)
            expl = _lin(lambda a: a[..., :K, :] * beta[:, :, None], phi)
            # "order k" = k predictor terms: p is the order-k
            # Adams-Bashforth value; the corrector's g_k phi^p_k term makes
            # it the order-(k+1) Adams-Moulton value
            p = h + dt_eff[:, None] * _lin(
                lambda a: torch.einsum("nj,...njh->...nh", gpm, a), expl)
            f_p = field(next_t, p)
            prefix = _lin(lambda a: torch.cat(
                [torch.zeros_like(a[..., :1, :]), torch.cumsum(a, dim=-2)],
                dim=-2), expl)                                # [N, K+1, H]
            php = _lin(lambda a: a[..., None, :], f_p) - prefix
            y_next = p + dt_eff[:, None] * _take1(g, order)[:, None] \
                * _takeh(php, order)
            # the second evaluation refreshes the difference table
            f_n = field(next_t, y_next)
            phi_full = _lin(lambda a: a[..., None, :], f_n) - prefix
            keep = (jidx[None, :] <= (order + 1)[:, None])[:, :, None]
            phi_new = _lin(lambda a: torch.where(keep, a, 0.0), phi_full)

            # the controller, detached (see _run_embedded)
            hd, yd = _p(h).detach(), _p(y_next).detach()
            php_d, phi_d = _p(php).detach(), _p(phi_full).detach()
            tol = atol + rtol * torch.maximum(hd.abs(), yd.abs())
            err_k = ratio(dt_eff[:, None] * (
                _take1(g, order + 1) - _take1(g, order))[:, None]
                * _takeh(php_d, order + 1), tol)
            accept = (err_k <= 1.0) & active
            # order selection: startup ramps 1 -> 3, then the embedded
            # estimates at orders k-2..k+1 (the raise test by the gamma*
            # proxy on the freshest high difference)
            om1 = torch.clamp(order - 1, min=0)
            om2 = torch.clamp(order - 2, min=0)
            err_km1 = ratio(dt_eff[:, None] * (
                _take1(g, order) - _take1(g, om1))[:, None]
                * _takeh(php_d, order), tol)
            err_km2 = ratio(dt_eff[:, None] * (
                _take1(g, om1) - _take1(g, om2))[:, None]
                * _takeh(php_d, om1), tol)
            err_kp1 = ratio(dt_eff[:, None]
                            * _take1(gs_tab, order + 2)[:, None]
                            * _takeh(phi_d, order + 1), tol)
            # lower only when both lower-order estimates beat order k
            # (Shampine-Gordon's max-test; a min-test thrashes in f32
            # roundoff once the high differences reach the floor)
            down = torch.maximum(err_km1, err_km2) <= err_k
            up = (~down) & (order < K - 1) & (err_kp1 < err_k)
            adaptive = order + torch.where(down, -1, torch.where(up, 1, 0))
            startup = (nhist <= 4) | (order < 3)
            next_order = torch.clamp(torch.where(
                startup, torch.clamp(order + 1, max=3), adaptive), 1, K - 1)
            # torchdiffeq's constants: safety 0.9, growth <= 10, shrink
            # >= 0.2, exponent 1/(order+2); a step that raises the order
            # keeps its size
            fac = torch.clamp(0.9 * (err_k + 1e-12)
                              ** (-1.0 / (order.to(dtype) + 2.0)), 0.2, 10.0)
            dt_new = torch.where(accept, torch.where(
                next_order > order, dt_eff, dt_eff * fac), dt_eff * fac)
            acc_h = accept[:, None]
            return (_where(acc_h, y_next, h),
                    torch.where(accept, next_t, t),
                    torch.where(active, torch.maximum(dt_new, span / 1e4), dt),
                    torch.where(accept, next_order, order),
                    torch.where(accept, torch.clamp(nhist + 1, max=K + 2),
                                nhist),
                    torch.where(acc_h, torch.cat(
                        [next_t[:, None], tprev[:, :-1]], dim=1), tprev),
                    _where(accept[:, None, None], phi_new, phi))

        new = _attempts(attempt, carry, t1, max_steps, record, l)
        # budget exhaustion: NaN under ode_strict, else one forced
        # error-unchecked Euler step over the rest, after which the
        # history restarts at order 1 at t1
        h, t_i, dt_i, order, nhist, tprev, phi = new
        left = torch.clamp(t1 - t_i, min=0.0)
        exhausted = left > 1e-12
        if _any(exhausted, record, -1 - l):
            if strict:
                h = _poison(exhausted[:, None], h)
            else:
                h = _where(exhausted[:, None],
                           h + left[:, None] * field(t_i, h), h)
                phi = _where(exhausted[:, None, None],
                             fresh_table(field(t1, h)), phi)
                tprev = torch.where(exhausted[:, None],
                                    t1[:, None] - back[None, :], tprev)
                order = torch.where(exhausted, 1, order)
                nhist = torch.where(exhausted, 1, nhist)
            t_i = torch.where(exhausted, t1, t_i)
        return _select_all(m_l, (h, t_i, dt_i, order, nhist, tprev, phi),
                           carry)

    t0 = t_start.to(dtype)
    ones = torch.ones((n,), dtype=torch.long, device=dev)
    # staggered stand-in history times keep the coefficients' denominators
    # finite before a real history exists (their phi rows are zero)
    carry0 = (h0, t0, torch.zeros_like(t0), ones, ones,
              t0[:, None] - back[None, :], fresh_table(field(t0, h0)))
    return _scan(interval, carry0, times, mask, remat, closed, states=(0, 6))


# ---------------------------------------------------------------------------
# entry points

def integrate(field: Field, h0, times: torch.Tensor, t_start: torch.Tensor,
              mask: torch.Tensor, n_sub: int, method: str = "midpoint",
              remat: bool = False, closed=None):
    """Integrate ``dh/dt = field(t, h)`` to every valid sample time with a
    fixed-step scheme (:data:`FIXED_METHODS`).

    ``h0 [N, H]``, ``times [N, L]``, ``t_start [N]``, ``mask [N, L]``.
    Returns ``hs [N, L, H]``: the state at each sample time (the stale
    carry at invalid positions; callers mask them out). The Adams
    multisteps carry their history across the ``n_sub`` substeps of an
    interval and restart at its end, ramping the order 1 -> 4. With a
    :class:`Jet` ``h0`` (and a field that takes Jets) the tangents ride
    along: ``hs`` is then a Jet of ``[N, L, H]`` and ``[D, N, L, H]``.
    ``remat`` recomputes each sample interval in the backward instead of
    storing its activations; it needs ``closed``: every tensor the field
    closes over that needs a gradient (its parameters), since their
    gradients come from the recompute.
    """
    check_method(method)
    if method not in FIXED_METHODS:
        raise ValueError(f"integrate takes {FIXED_METHODS}, got {method!r}"
                         " (integrate_adaptive takes the adaptive methods)")
    return _run_fixed(field, h0, times, t_start, mask, n_sub, method, remat,
                      closed)


def integrate_adaptive(field: Field, h0, times: torch.Tensor,
                       t_start: torch.Tensor, mask: torch.Tensor,
                       rtol: float = 1e-5, atol: float = 1e-6,
                       max_steps: int = 16, remat: bool = False,
                       strict: bool = False, method: str = "dopri5",
                       closed=None):
    """Adaptive integration along each path's sample grid
    (:data:`ADAPTIVE_METHODS`): per-path step sizes under an
    error-controlled accept/reject controller, at most ``max_steps``
    attempts per sample interval; a path that exhausts them takes one
    forced full-span step, or is NaN with ``strict``. Same shapes, and
    the same :class:`Jet` form, as :func:`integrate`."""
    check_method(method)
    if method not in ADAPTIVE_METHODS:
        raise ValueError(f"integrate_adaptive takes {ADAPTIVE_METHODS}, got "
                         f"{method!r}")
    if method == "adams":
        return _run_vcabm(field, h0, times, t_start, mask, rtol, atol,
                          max_steps, strict, remat, closed)
    return _run_embedded(field, h0, times, t_start, mask, rtol, atol,
                         max_steps, strict, method, remat, closed)
