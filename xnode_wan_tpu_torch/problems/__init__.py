"""Problem-definition API: a PDE as a bundle of pointwise torch callables.

All callables act on ``[..., C]`` tensors with time at channel 0, as in
the JAX package's ``xnode_wan_tpu/problems``. ``a_kind`` declares the
structure of the diffusion matrix (zero|isotropic|diagonal|full).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class Problem:
    """A parabolic boundary-value PDE:

    ``d_t u - sum_i d_i(sum_j a_ij d_j u) + sum_i b_i d_i u + c(u) u = f``
    with ``u = g`` on the lateral boundary and ``u(T0, .) = h``.
    """

    name: str
    h: Callable[[Any], Any]                   # initial data, on [..., C] points
    f: Callable[[Any], Any]                   # source term
    g: Callable[[Any], Any]                   # boundary data
    c: Callable[[Any, Any], Any]              # reaction coefficient c(X, u)
    a_kind: str = "isotropic"                 # zero|isotropic|diagonal|full
    a: Optional[Callable[[Any], Any]] = None  # diffusion (per a_kind shape)
    b: Optional[Callable[[Any], Any]] = None  # drift [..., d] (None = zero)
    u_sol: Optional[Callable[[Any], Any]] = None  # exact solution, if known
    stop_rel_err: Optional[float] = None      # early-stop threshold on rel-L^p
    dim: Optional[int] = None                 # spatial dim, if the funcs fix it

    def __post_init__(self):
        if self.a_kind not in ("zero", "isotropic", "diagonal", "full"):
            raise ValueError(f"unknown a_kind {self.a_kind!r}")
        if self.a_kind != "zero" and self.a is None:
            object.__setattr__(self, "a", lambda X: 1.0)


_PKG = "xnode_wan_tpu_torch.problems"
_ALIASES = {
    "cube_pde": f"{_PKG}.cube_pde",
    "cube_pde_funcs": f"{_PKG}.cube_pde",
    "Ex4_1_funcs": f"{_PKG}.ex4_1",
    "ex4_1": f"{_PKG}.ex4_1",
    "Ex4_3_funcs": f"{_PKG}.ex4_3",
    "ex4_3": f"{_PKG}.ex4_3",
    "Ex4_3_consistent": f"{_PKG}.ex4_3:consistent",
    "ex4_3_consistent": f"{_PKG}.ex4_3:consistent",
}
_NOT_PORTED = (f"{_PKG}.ex4_3",)


def load_problem(spec: str, dim: Optional[int] = None) -> Problem:
    """Resolve a problem by shipped name (same aliases as the JAX package)
    or by a dotted module path exposing ``get_problem(dim)`` or
    ``PROBLEM``."""
    target = _ALIASES.get(spec, spec)
    variant = None
    if ":" in target:
        target, variant = target.split(":", 1)
    if target in _NOT_PORTED:
        raise NotImplementedError(
            f"problem {spec!r} is not ported to PyTorch yet (see ROADMAP.md)")
    module = importlib.import_module(target)
    if variant == "consistent":
        return module.get_problem_consistent(dim)
    if hasattr(module, "get_problem"):
        return module.get_problem(dim)
    return module.PROBLEM
