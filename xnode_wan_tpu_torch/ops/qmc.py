"""Randomized quasi-Monte-Carlo (shifted scrambled Halton) sample clouds.

Port of ``xnode_wan_tpu/ops/qmc.py``. The weak-form objective, its
gradients and the per-iteration rel-L^p metric are Monte-Carlo estimates
over a fresh interior cloud; a randomized low-discrepancy cloud lowers
their variance without biasing them (Cranley-Patterson rotation):

* a scrambled Halton base set ``H in [0,1)^{n x d}`` is built once per
  ``(n, d)`` on the host (:func:`halton_base`, numpy) and kept on the
  device per ``(n, d, dtype, device)`` (:func:`_device_base`);
* each draw takes one uniform shift ``s ~ U[0,1)^d`` from the caller's
  ``torch.Generator`` on its device and returns ``frac(H + s)``, so a step
  costs one ``d``-vector draw and one add, with no host-to-device copy.

The base set is the JAX package's, bit for bit: the digit permutations
come from ``np.random.RandomState(0)``, whose stream numpy keeps fixed, so
the base is a pure function of ``(n, d)`` everywhere. The numpy code is
copied here because the JAX module imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
           61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127,
           131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193,
           197, 199, 211, 223, 227, 229, 233]  # 51 primes: the d+1 columns
# qmc_ball needs at d = 50


def _scrambled_radical_inverse(indices: np.ndarray, base: int,
                               perms: np.ndarray) -> np.ndarray:
    """Digit-scrambled van der Corput radical inverse in ``base`` (f64).

    ``perms [n_digits, base]`` maps the digit at each position through its
    own permutation; every permutation fixes 0, so the trailing zero
    digits contribute nothing and truncation is exact.
    """
    idx = indices.astype(np.int64)
    out = np.zeros(idx.shape, dtype=np.float64)
    f = 1.0 / base
    k = 0
    while idx.max(initial=0) > 0:
        out += f * perms[k][idx % base]
        idx //= base
        f /= base
        k += 1
    return out


@functools.lru_cache(maxsize=16)
def halton_base(n: int, dim: int) -> np.ndarray:
    """Scrambled-Halton base set ``[n, dim]`` in [0,1) (host, cached).

    The per-dimension, per-digit-position permutations are drawn from
    ``np.random.RandomState(0)`` in dimension-major order. Covers ``dim <=
    51``.
    """
    if dim > len(_PRIMES):
        raise ValueError(
            f"halton_base: dim={dim} exceeds the built-in prime table "
            f"({len(_PRIMES)})")
    rs = np.random.RandomState(0)
    idx = np.arange(1, n + 1)  # skip the all-zeros point
    cols = []
    for p in _PRIMES[:dim]:
        n_digits = 1
        while p ** n_digits <= n:
            n_digits += 1
        perms = np.stack([
            np.concatenate(([0], 1 + rs.permutation(p - 1)))
            for _ in range(n_digits)])
        cols.append(_scrambled_radical_inverse(idx, p, perms))
    return np.stack(cols, axis=1)


@functools.lru_cache(maxsize=16)
def _device_base(n: int, dim: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """:func:`halton_base` on ``device`` in ``dtype``, copied once."""
    return torch.as_tensor(halton_base(n, dim), dtype=dtype, device=device)


def qmc_uniform(generator: torch.Generator, n: int, dim: int, dtype,
                minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Shifted-Halton ``[n, dim]`` draw in ``[minval, maxval)`` on the
    generator's device: the generator only feeds the ``dim``-vector shift,
    so equal generator states give equal clouds."""
    dev = generator.device
    base = _device_base(n, dim, dtype, dev)
    shift = torch.rand((dim,), generator=generator, device=dev, dtype=dtype)
    u01 = torch.remainder(base + shift[None, :], 1.0)
    return minval + (maxval - minval) * u01


def _gauss_dirs(u: torch.Tensor) -> torch.Tensor:
    """Uniform directions on S^{d-1} from uniform columns ``u [n, d]``: the
    inverse normal CDF per coordinate, then normalization. ``ndtri``
    diverges at {0, 1}, and the shifted base can hit an exact 0, so the
    columns are clamped into the open interval."""
    tiny = 1e-7 if u.dtype == torch.float32 else 1e-15
    g = torch.special.ndtri(torch.clamp(u, tiny, 1.0 - tiny))
    return g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                           min=1e-20)


def qmc_ball(generator: torch.Generator, n: int, dim: int, radius: float,
             dtype) -> torch.Tensor:
    """RQMC uniform draw in the ``dim``-ball of ``radius``: ``dim + 1``
    shifted-Halton columns, the first ``dim`` to a direction, the last to
    the radius ``U^{1/d}``, kept off the origin as ``sampling._ball``
    does (the gradient of ``|x|`` at 0 is NaN)."""
    u = qmc_uniform(generator, n, dim + 1, dtype)
    dirs = _gauss_dirs(u[:, :dim])
    ur = torch.clamp(u[:, dim:], min=1e-6)
    return radius * dirs * ur ** (1.0 / dim)


def qmc_time_sphere(generator: torch.Generator, n: int, dim: int, dtype):
    """RQMC pair for the moving domains' boundary clouds: a uniform column
    ``u [n]`` for the caller's time inverse CDF (a monotone map, so its
    low discrepancy survives) and matched directions ``dirs [n, dim]``
    from the other columns."""
    u = qmc_uniform(generator, n, dim + 1, dtype)
    return u[:, 0], _gauss_dirs(u[:, 1:])
