"""Paper example 4.1: the cube_pde problem with a 1% relative-L^2 early stop
(reference ``configs/Ex4_1_funcs.py``)."""

from __future__ import annotations

import dataclasses

from xnode_wan_tpu_torch.problems import cube_pde

PROBLEM = dataclasses.replace(cube_pde.PROBLEM, name="ex4_1",
                              stop_rel_err=0.01)


def get_problem(dim=None):
    del dim
    return PROBLEM
