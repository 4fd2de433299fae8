"""The port's meshes over ``torch.distributed``: the layouts against the
JAX package's, and two ``gloo`` ranks spawned on the CPU
(``test_torch_parallel_ranks.py``) against the single-process twin.

Tolerances: one f64 outer step at 1e-9 relative (the ranks sum their
shards' parts and then all-reduce, so the order of the sums differs);
the f32 ``fused_v`` steps (the plain versions of kernels #2-#7 on each
rank's rows; under ``ensemble: 2`` a member a rank, under
``tangent_shards: 2`` the u side plain and #2, #6 and #7 kept, each
against the fused single process) at the f32 tolerances of ``test_one_outer_step_matches_jax``,
1e-4 on parameters and moments and 1e-5 on metrics; 20 iterations at the
JAX package's 2e-4 (``tests/test_parallel.py:36-56``). Serving on the mesh
is held bitwise against serving without one.
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from xnode_wan_tpu.parallel.mesh import make_mesh_ensemble as jmake_ensemble
from xnode_wan_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                               make_mesh_ensemble, round_up,
                                               shard_batch)
import test_torch_parallel_ranks as ranks

WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every case on two ranks, in one spawn; each rank's results."""
    out = tmp_path_factory.mktemp("ranks")
    cases = [*ranks.CASES, "serve", "cli"]
    mp.spawn(ranks.rank_main, args=(WORLD, free_port(), str(out), cases),
             nprocs=WORLD, join=True)
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


def rounded(name, n_data):
    kw = ranks.CASES[name][0]
    return {k: round_up(kw[k], n_data) for k in ("N_r", "N_b")}


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("devices,k", [(8, 4), (2, 4), (4, 2)])
def test_ensemble_layouts_match_jax(devices, k):
    jmesh = jmake_ensemble(jax.devices()[:devices], k)
    mesh = make_mesh_ensemble(list(range(devices)), k)
    assert mesh.axis_names == tuple(jmesh.axis_names)
    np.testing.assert_array_equal(
        mesh.ranks, np.vectorize(lambda d: d.id)(jmesh.devices))
    assert mesh.shape == dict(jmesh.shape)


def test_impossible_layouts_raise():
    with pytest.raises(ValueError, match="ensemble=4 cannot be laid out"):
        make_mesh_ensemble(list(range(6)), 4)
    with pytest.raises(Exception):
        jmake_ensemble(jax.devices()[:6], 4)
    with pytest.raises(ValueError, match="tangent_shards=2"):
        make_mesh_2d([0, 1, 2], tangent_shards=2)
    mesh = make_mesh_2d(list(range(8)), tangent_shards=2)
    assert mesh.shape == {"data": 4, "tangent": 2}
    assert make_mesh([0, 1, 2]).shape == {"data": 3}


def test_round_up_and_shard_batch():
    assert [round_up(n, 4) for n in (1, 4, 5, 4001)] == [4, 4, 8, 4004]
    assert shard_batch("batch", None) == "batch"
    assert shard_batch("batch", make_mesh([0], "data")) == "batch"


@pytest.mark.parametrize("name,rtol,rtol_metrics", [
    ("cube", 1e-9, 1e-9), ("cube_odd_nr", 1e-9, 1e-9),
    ("cube_f32_fused_v", 1e-4, 1e-5), ("hourglass", 1e-9, 1e-9),
    ("ensemble", 1e-9, 1e-9), ("tangent", 1e-9, 1e-9),
    ("ensemble_f32_fused_v", 1e-4, 1e-5), ("tangent_f32_fused_v", 1e-4, 1e-5),
    ("cube_20", 2e-4, 2e-4)])
def test_two_ranks_match_one_process(spawned, tmp_path, name, rtol,
                                     rtol_metrics):
    out, results = spawned
    kw = ranks.CASES[name][0]
    n_data = 1 if kw.get("ensemble", 1) > 1 or "tangent_shards" in kw \
        else WORLD
    override = rounded(name, n_data)
    if "tangent_shards" in kw:   # one process carries all d directions
        override["tangent_shards"] = 1
    twin = ranks.run_case(name, str(tmp_path), **override)
    for rank, res in enumerate(results):
        got = res[name]
        assert (got["N_r"], got["N_b"]) == (twin["N_r"], twin["N_b"])
        assert got["steps"] == twin["steps"]
        for k, v in twin["metrics"].items():
            close(got["metrics"][k], v, rtol_metrics)
        if kw.get("ensemble", 1) == 1:
            # every rank holds the same parameters, bit for bit
            for a, b in zip(got["state"], results[0][name]["state"]):
                np.testing.assert_array_equal(a, b)
        # a rank of the ensemble steps its own member (member x data: 2 x 1)
        n = len(got["state"])
        want = twin["state"][rank * n:(rank + 1) * n] \
            if kw.get("ensemble", 1) > 1 else twin["state"]
        assert n == len(want)
        for a, b in zip(got["state"], want):
            close(a, b, rtol)
    if ranks.CASES[name][2] == 1:
        # rank 0 wrote the checkpoint, every member in it
        sd = torch.load(out / f"{name}_rank0" / "checkpoint_NODE.pt",
                        weights_only=True)
        want = torch.load(tmp_path / "checkpoint_NODE.pt", weights_only=True)
        assert not (out / f"{name}_rank1").exists()
        for m_got, m_want in zip(sd["members"], want["members"]):
            for key in ("u_params", "v_params"):
                for k, v in m_want[key].items():
                    close(m_got[key][k].numpy(), v.numpy(), rtol)
            assert m_got["step"] == m_want["step"]


def test_sharded_serving_is_bitwise(spawned):
    _, results = spawned
    for res in results:
        for name, (sharded, whole, predicted) in res["serve"].items():
            assert sharded.shape == (101,)
            np.testing.assert_array_equal(sharded, whole, err_msg=name)
            np.testing.assert_array_equal(predicted, whole, err_msg=name)


def test_only_rank_zero_writes(spawned):
    _, results = spawned
    written, other = results[0]["cli"], results[1]["cli"]
    assert other == []
    for name in ("metrics_NODE_2.jsonl", "checkpoint_NODE.pt",
                 "best_model_weights_NODE.pth", "losses_NODE_2.json",
                 "guess_cn.npy", "plot_at_0_along_[0, 1].png"):
        assert name in written, (name, written)


def test_fused_gates_on_meshes():
    # a rank of a data or member mesh runs the kernels on its own rows; a
    # tangent axis closes the u side only (its ranks carry slices of the d
    # directions that #3-#5 compute whole); #2 and #6/#7 read no tangent
    from xnode_wan_tpu_torch import SolverConfig
    from xnode_wan_tpu_torch.ops.weak_form import (fused_gate, fused_v_gate,
                                                   kernel_gate)
    cfg = SolverConfig(fused_v=True)
    data, two_d = make_mesh([0, 1]), make_mesh_2d([0, 1], tangent_shards=2)
    members = make_mesh_ensemble([0, 1], 2)
    assert fused_gate(cfg) and fused_gate(cfg, data)
    assert not fused_gate(cfg, two_d)
    assert fused_gate(cfg.replace(ensemble=2))
    assert fused_gate(cfg.replace(ensemble=2), members)
    assert kernel_gate(cfg) and fused_v_gate(cfg)
    assert fused_v_gate(cfg.replace(ensemble=2))
