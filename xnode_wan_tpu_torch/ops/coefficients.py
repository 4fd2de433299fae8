"""PDE coefficient contractions that touch only the structure a problem
declares. Port of ``xnode_wan_tpu/ops/coefficients.py``.

Problems declare the diffusion matrix's structure (``a_kind``: zero,
isotropic, diagonal, full), so ``sum_ij a_ij d_i(phi) d_j(u)`` never
materializes a dense ``[d, d, N, L]`` tensor unless the matrix is dense.
Adapters turn reference-style entrywise callables (``func_a(X, i, j)``,
``func_b(X, i)``) into stacked ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def diffusion_term(problem, X: torch.Tensor, dphi_x: torch.Tensor,
                   du: torch.Tensor) -> torch.Tensor:
    """``sum_ij a_ij d_i(phi) d_j(u)`` -> ``[N, L]`` (reference
    ``src/loss.py:66-68``: ``a[i, j] * dphi_{i+1} * du_{j+1}``)."""
    kind = problem.a_kind
    if kind == "zero" or problem.a is None:
        return torch.zeros(X.shape[:-1], dtype=dphi_x.dtype, device=X.device)
    a = problem.a(X)
    if kind == "isotropic":
        return a * torch.sum(dphi_x * du, dim=-1)
    if kind == "diagonal":
        return torch.sum(a * dphi_x * du, dim=-1)
    if kind == "full":
        return torch.einsum("...ij,...i,...j->...", a, dphi_x, du)
    raise ValueError(f"unknown a_kind {kind!r}")


def drift_term(problem, X: torch.Tensor, phi: torch.Tensor,
               du: torch.Tensor) -> torch.Tensor:
    """``sum_i b_i phi d_i(u)`` -> ``[N, L]`` (reference ``src/loss.py:69``)."""
    if problem.b is None:
        return torch.zeros(X.shape[:-1], dtype=phi.dtype, device=X.device)
    return phi * torch.sum(problem.b(X) * du, dim=-1)


def _as_tensor(v, X: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(v, dtype=X.dtype,
                                              device=X.device), X.shape[:-1])


def full_a_from_entries(func_a: Callable, dim: int) -> Callable:
    """Reference-style ``func_a(X, i, j)`` -> dense ``a(X) [..., d, d]``."""
    def a(X):
        rows = [torch.stack([_as_tensor(func_a(X, i, j), X)
                             for j in range(dim)], dim=-1)
                for i in range(dim)]
        return torch.stack(rows, dim=-2)
    return a


def b_from_entries(func_b: Optional[Callable], dim: int) -> Optional[Callable]:
    """Reference-style ``func_b(X, i)`` -> ``b(X) [..., d]``."""
    if func_b is None:
        return None

    def b(X):
        return torch.stack([_as_tensor(func_b(X, i), X) for i in range(dim)],
                           dim=-1)
    return b
