"""2-D contour plots of the guess, the exact solution and the error.

Port of ``xnode_wan_tpu/utils/viz.py`` (reference
``utils/auxillary_funcs.py:34-98``, ``proj``): a slice of the domain along
two axes, the other coordinates fixed at 0.5, evaluated on a
``resolution^2`` grid through the caller's ``predict`` (the solver's,
which on the GPU is kernel #1); ``guess_cn.npy`` and ``error_cn.npy`` are
written first, then ``plot_at_<k>_along_<axes>.png``. matplotlib is
imported only after the arrays are written, so that a machine without it
still keeps them (the caller decides what its ImportError means).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def slice_points(dim: int, axes: Sequence[int] = (0, 1), T: float = 1.0,
                 T0: float = 0.0, down: float = -1.0, up: float = 1.0,
                 resolution: int = 100):
    """The slice's points ``[resolution^2, dim + 1]`` (float32, built as
    the JAX package builds them) and its two grids ``(x_mesh, t_mesh)``."""
    assert len(axes) == 2, "exactly two axes can be displayed"
    r = resolution
    xt = np.full((r, r, dim + 1), 0.5, dtype=np.float32)
    if 0 in axes:
        t_mesh = np.linspace(T0, T, r, dtype=np.float32)
    else:
        t_mesh = np.linspace(down, up, r, dtype=np.float32)
        xt[:, :, 0] = T
    x_mesh = np.linspace(down, up, r, dtype=np.float32)
    mesh1, mesh2 = np.meshgrid(x_mesh, t_mesh, indexing="ij")
    xt[:, :, axes[0]] = mesh2
    xt[:, :, axes[1]] = mesh1
    return xt.reshape(-1, dim + 1), x_mesh, t_mesh


def proj(predict: Callable, dim: int, iteration: int,
         axes: Sequence[int] = (0, 1), T: float = 1.0, T0: float = 0.0,
         down: float = -1.0, up: float = 1.0, resolution: int = 100,
         colours: int = 8, save: bool = False, show: bool = False,
         func_u_sol: Optional[Callable] = None, work_dir: str = "./",
         domain=None) -> None:
    """Contour the solution along two axes.

    ``predict``: ``[M, C] -> [M]``, the primal at points (the solver's
    ``predict``). ``domain``: with a ``func_w`` (the moving domains), grid
    points outside the domain (``func_w < 0``) are NaN, so the contours
    show only the region the solution is defined on.
    """
    r = resolution
    xt, x_mesh, t_mesh = slice_points(dim, axes, T, T0, down, up, r)
    pts = torch.as_tensor(xt)
    guess = (predict(pts).detach().cpu().numpy().reshape(r, r)
             .astype(np.float64))
    if domain is not None and hasattr(domain, "func_w"):
        inside = (domain.func_w(pts) >= 0).cpu().numpy()
        guess = np.where(inside.reshape(r, r), guess, np.nan)
    sol = None
    if func_u_sol is not None:
        sol = func_u_sol(pts).detach().cpu().numpy().reshape(r, r)
        np.save(os.path.join(work_dir, "guess_cn.npy"), guess)
        np.save(os.path.join(work_dir, "error_cn.npy"), guess - sol)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.clf()
    if sol is not None:
        fig, ax = plt.subplots(3)
        for a, z in zip(ax, [sol, guess, guess - sol]):
            cs = a.contourf(x_mesh, t_mesh, z.T, colours)
            fig.colorbar(cs, ax=a)
        ax[0].set_title("Correct Solution, Guess and Error")
    else:
        fig, ax = plt.subplots(1)
        cs = ax.contourf(x_mesh, t_mesh, guess.T, colours)
        fig.colorbar(cs, ax=ax)
        ax.set_title("Guess Solution")
    if save:
        fig.savefig(os.path.join(
            work_dir, f"plot_at_{iteration}_along_{list(axes)}.png"))
    if show:  # pragma: no cover - interactive only
        plt.show()
    plt.close(fig)
