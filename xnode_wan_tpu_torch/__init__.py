"""xnode_wan_tpu_torch: the XNODE-WAN solver ported to PyTorch and CUDA.

A second package beside the JAX reference ``xnode_wan_tpu``; it imports
neither JAX nor that package. It serves a trained XNODE
(:func:`evaluate_points`, through the CUDA kernel ``csrc/xnode_fwd.cu``),
scores it on fresh sample paths (:func:`u_forward_fused`, through the
same source's path forward, and :func:`rel_err`), and trains it
(:class:`NODEWANSolver`, whose weak-form loss takes ``u`` and ``grad_x u``
from :func:`u_du_fused`, through ``csrc/xnode_grad.cu``, and with
``fused_v`` the adversary side from :func:`v_dv_fused`, through
``csrc/disc_fwd.cu`` and ``csrc/disc_train.cu``), on the hypercube or the
moving domains :class:`NSphereTCone` and :class:`NSphereTHourglass`
(:func:`make_domain`), with i.i.d. or randomized-Halton clouds
(``ops/qmc.py``), and with any of the JAX package's integrators
(:func:`integrate`, :func:`integrate_adaptive`; the continuous adjoint
in :func:`apply_xnode_adjoint`). The primal is the XNODE or the plain MLP
:class:`WAN` (``primal: wan``), and ``ensemble: K`` trains K members at
once. ``python -m xnode_wan_tpu_torch.main`` is the
command line, with logs, checkpoints, resume and contour plots
(:func:`proj`); :meth:`NODEWANSolver.train` runs in chunks with an exact
stop, and ``from_reference`` takes the reference's constructor.
``parallel`` lays ``torch.distributed`` ranks out as data, member and
tangent meshes (:func:`init_distributed`, :func:`make_mesh`). Entry
points run on the current CUDA device unless the caller passes
``device="cpu"``; CPU tensors take the kernels' plain PyTorch versions.
"""

from xnode_wan_tpu_torch.config import SolverConfig, load_params
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.discriminator import init_discriminator
from xnode_wan_tpu_torch.models.wan import WAN
from xnode_wan_tpu_torch.models.xnode import (XNODE, apply_xnode,
                                              apply_xnode_adjoint,
                                              evaluate_points, init_xnode)
from xnode_wan_tpu_torch.ops.kernels.disc_train import (v_dv_fused,
                                                         v_fused_fits)
from xnode_wan_tpu_torch.ops.integrate import integrate, integrate_adaptive
from xnode_wan_tpu_torch.ops.kernels.xnode_eval import fused_evaluate
from xnode_wan_tpu_torch.ops.kernels.xnode_train import (fused_from_batch,
                                                          u_du_fused,
                                                          u_forward_fused)
from xnode_wan_tpu_torch.ops.sampling import (DOMAIN_REGISTRY, CombLoader,
                                              Hypercube, NSphereTCone,
                                              NSphereTHourglass, PathBatch,
                                              fillt, make_domain)
from xnode_wan_tpu_torch.ops.weak_form import make_losses, v_phi_grads_fused
from xnode_wan_tpu_torch.parallel import (init_distributed, make_mesh,
                                          make_mesh_2d, make_mesh_ensemble)
from xnode_wan_tpu_torch.problems import Problem, load_problem
from xnode_wan_tpu_torch.training import NODEWANSolver
from xnode_wan_tpu_torch.utils.logging import RunLogger
from xnode_wan_tpu_torch.utils.metrics import l_norm, rel_err
from xnode_wan_tpu_torch.utils.torch_compat import (disc_params_from_jax,
                                                    load_reference_state_dict,
                                                    params_from_jax,
                                                    wan_params_from_jax)
from xnode_wan_tpu_torch.utils.viz import proj

# the reference's class names (src/dataset.py, src/training.py), as the
# JAX package's __init__ gives them
NSphere_TCone = NSphereTCone
NSphere_THourglass = NSphereTHourglass
NODE_WAN_solver = NODEWANSolver

__all__ = [
    "SolverConfig", "load_params", "default_device", "XNODE", "init_xnode",
    "apply_xnode", "evaluate_points", "fused_evaluate", "u_forward_fused",
    "Hypercube", "NSphereTCone", "NSphereTHourglass", "make_domain",
    "PathBatch", "Problem", "load_problem", "l_norm", "rel_err",
    "load_reference_state_dict", "params_from_jax", "disc_params_from_jax",
    "NODEWANSolver", "make_losses", "u_du_fused", "fused_from_batch",
    "init_discriminator", "v_dv_fused", "v_fused_fits", "v_phi_grads_fused",
    "RunLogger", "WAN", "wan_params_from_jax", "integrate",
    "integrate_adaptive", "apply_xnode_adjoint", "fillt", "CombLoader",
    "DOMAIN_REGISTRY", "NSphere_TCone", "NSphere_THourglass",
    "NODE_WAN_solver", "proj", "init_distributed", "make_mesh",
    "make_mesh_2d", "make_mesh_ensemble",
]
