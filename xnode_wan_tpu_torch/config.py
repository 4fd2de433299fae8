"""Configuration for the XNODE-WAN solver (PyTorch port).

Same YAML key set, defaults, coercions and validation as the JAX
package's ``xnode_wan_tpu/config.py``: a flat reference-style params dict
is parsed by name into a frozen dataclass, and unknown keys are rejected.
Every shipped config loads and the trainer (``training.py``) acts on the
training fields, ``debug_nans`` among them (a ``FloatingPointError`` at
the first outer iteration with a NaN loss, metric or weight). The
JAX package's compiler knobs (``compile_cache``, ``scan_unroll``,
``window_target_s``) are read and unused, and so are ``fused_chunk`` and
``fused_chunk_max``: in the JAX package they let the u side run the
Pallas kernels in tangent chunks instead of its XLA route, at most
``fused_chunk_max`` of them. The port has no XLA route to prefer, so it
needs no opt-in: its u side runs kernels #3-#5 in the largest tangent
chunk that fits whenever the full d does not
(``ops/kernels/xnode_train.py::u_chunk``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Mapping

import yaml

_FLOAT_FIELDS = ("alpha", "u_rate", "v_rate", "T0", "T", "p", "ode_rtol",
                 "ode_atol", "ema_decay", "window_target_s", "grad_clip",
                 "lr_decay", "u_scale")
_INT_FIELDS = ("u_layers", "u_hidden_dim", "u_hidden_hidden_dim", "v_layers",
               "v_hidden_dim", "n1", "n2", "min_steps", "dim", "N_t", "N_r",
               "N_b", "iterations", "seed", "ensemble", "ode_max_steps",
               "train_chunk", "tangent_shards", "fourier_features",
               "v_fourier_features", "scan_unroll")
VALID_SOLVERS = ("euler", "midpoint", "heun", "rk4", "explicit_adams",
                 "fixed_adams", "dopri5", "bosh3", "adaptive_heun",
                 "fehlberg2", "dopri8", "adams")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """All hyperparameters of a solver run (reference YAML key names)."""

    # "config" block
    alpha: float = 1e8
    u_layers: int = 8             # depth of the ODE field MLP
    u_hidden_dim: int = 20        # XNODE hidden state width H
    u_hidden_hidden_dim: int = 10  # ODE field MLP width Hh
    v_layers: int = 9
    v_hidden_dim: int = 50
    n1: int = 2
    n2: int = 1
    u_rate: float = 0.015
    v_rate: float = 0.04
    min_steps: int = 5            # min ODE steps over [T0, T]
    adjoint: bool = False
    solver: str = "midpoint"

    # "setup" block
    dim: int = 5
    N_t: int = 20
    N_r: int = 4000
    N_b: int = 4000
    T0: float = 0.0
    T: float = 1.0
    shape_param: Any = (-1.0, 1.0)

    iterations: int = 1000
    domain: str = "Hypercube"

    # extensions of the JAX package (same names and defaults)
    primal: str = "xnode"
    tied_v: bool = True
    x64: bool = False
    seed: int = 0
    profile_dir: str = ""
    debug_nans: bool = False
    use_pallas: bool = True       # here: the hand-written CUDA kernels
    fused_grad: bool = True
    fused_chunk: bool = False
    fused_chunk_max: int = 2
    compile_cache: str = "auto"
    grad_clip: float = 0.0
    lr_decay: float = 1.0
    boundary_paths: bool = True
    waist_cap: bool = False
    fused_v: bool = False
    group_loss: bool = True
    s1_raw_v: bool = False
    init_all_rows: bool = False
    independent_uv: bool = False
    ema_decay: float = 0.0
    ensemble: int = 1
    data_axis: str = "data"
    tangent_shards: int = 1
    remat_scan: bool = True
    scan_unroll: int = 1
    fourier_features: int = 0
    v_fourier_features: int = 0
    train_chunk: int = 10
    window_target_s: float = 60.0
    ode_rtol: float = 1e-5
    ode_atol: float = 1e-6
    ode_max_steps: int = 16
    ode_strict: bool = False
    qmc: str = "none"
    u_scale: float = 1.0
    p: float = 2.0

    def __post_init__(self):
        # PyYAML 1.1 parses unsigned-exponent floats ("1.0e8") as strings.
        for name in _FLOAT_FIELDS:
            object.__setattr__(self, name, float(getattr(self, name)))
        for name in _INT_FIELDS:
            # via float(): int("6.4e1") raises, int(float("6.4e1")) works
            object.__setattr__(self, name, int(float(getattr(self, name))))
        if self.ensemble < 1:
            raise ValueError("ensemble must be >= 1")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1)")
        if isinstance(self.shape_param, list):
            object.__setattr__(self, "shape_param", tuple(self.shape_param))
        if self.u_layers < 1:
            raise ValueError("u_layers must be >= 1")
        if self.solver not in VALID_SOLVERS:
            hint = ""
            if self.solver == "implicit_adams":
                hint = (" ('fixed_adams' is the fixed-step "
                        "predictor-corrector Adams, 'adams' the "
                        "adaptive-order VCABM)")
            raise ValueError(
                f"unknown solver {self.solver!r}; valid: {VALID_SOLVERS}"
                f"{hint}")
        if self.ode_max_steps < 1:
            raise ValueError("ode_max_steps must be >= 1")
        if self.solver in ("explicit_adams", "fixed_adams") and self.n_sub < 4:
            warnings.warn(
                f"solver={self.solver!r} with n_sub={self.n_sub} (from "
                f"min_steps={self.min_steps}, N_t={self.N_t}): multistep "
                "history restarts at each of the N_t sample intervals, so "
                f"the effective Adams order is capped at {self.n_sub}, not "
                "4. Raise min_steps (n_sub = ceil(2*min_steps/N_t) >= 4) "
                "to reach the advertised AB4/ABM4 order.",
                stacklevel=2)
        if self.primal not in ("xnode", "wan"):
            raise ValueError(f"unknown primal model {self.primal!r}")
        if self.N_t < 2:
            raise ValueError("N_t must be >= 2 (need both endpoints)")
        if self.T <= self.T0:
            raise ValueError("need T > T0")
        if self.qmc not in ("none", "halton"):
            raise ValueError(f"unknown qmc {self.qmc!r}; valid: none, halton")
        if self.independent_uv and self.domain != "Hypercube":
            raise ValueError(
                "independent_uv=true is only meaningful on the Hypercube "
                "domain (the reference pairs independent u/v clouds only "
                "there); on moving domains the v cloud's own masking "
                "would silently corrupt the paired weak-form estimator")

    @property
    def u_scale_eff(self) -> float:
        """Output normalization: ``u_scale <= 0`` means off (scale 1)."""
        return self.u_scale if self.u_scale > 0 else 1.0

    @property
    def n_sub(self) -> int:
        """Substeps per sample interval: stratified grids have max gap
        ``2(T-T0)/N_t``, so ``ceil(2 min_steps / N_t)`` substeps keep every
        ODE step ``<= (T-T0)/min_steps`` (the reference's fillt rule)."""
        return max(1, -(-2 * self.min_steps // max(self.N_t, 1)))

    @classmethod
    def from_dict(cls, params: Mapping[str, Any]) -> "SolverConfig":
        """Build from a reference-style flat params dict (extra keys rejected)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(params) - names
        if unknown:
            raise KeyError(f"unknown config keys: {sorted(unknown)}")
        return cls(**dict(params))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


def load_params(path: str) -> SolverConfig:
    """Load a reference-style YAML params file (configs/cube_pde.yaml keys)."""
    with open(path, "r") as fh:
        raw = yaml.safe_load(fh)
    return SolverConfig.from_dict(raw)

