"""xnode_wan_tpu_torch: the XNODE-WAN solver ported to PyTorch and CUDA.

A second package beside the JAX reference ``xnode_wan_tpu``; it imports
neither JAX nor that package. The slice ported so far serves a trained
XNODE (:func:`evaluate_points`, through the CUDA kernel
``csrc/xnode_eval.cu``) and scores it on fresh sample paths
(:func:`u_forward_fused`, through ``csrc/xnode_train.cu``, and
:func:`rel_err`). Entry points run on the current CUDA device unless the
caller passes ``device="cpu"``; CPU tensors take the kernels' plain
PyTorch versions.
"""

from xnode_wan_tpu_torch.config import SolverConfig, load_params
from xnode_wan_tpu_torch.device import default_device
from xnode_wan_tpu_torch.models.xnode import (XNODE, apply_xnode,
                                              evaluate_points, init_xnode)
from xnode_wan_tpu_torch.ops.kernels.xnode_eval import fused_evaluate
from xnode_wan_tpu_torch.ops.kernels.xnode_train import u_forward_fused
from xnode_wan_tpu_torch.ops.sampling import Hypercube, PathBatch
from xnode_wan_tpu_torch.problems import Problem, load_problem
from xnode_wan_tpu_torch.utils.metrics import l_norm, rel_err
from xnode_wan_tpu_torch.utils.torch_compat import (load_reference_state_dict,
                                                    params_from_jax)

__all__ = [
    "SolverConfig", "load_params", "default_device", "XNODE", "init_xnode",
    "apply_xnode", "evaluate_points", "fused_evaluate", "u_forward_fused",
    "Hypercube", "PathBatch", "Problem", "load_problem", "l_norm", "rel_err",
    "load_reference_state_dict", "params_from_jax",
]
