"""The port's samplers: the property tests of ``tests/test_sampling.py``
(torch and JAX generators draw different numbers, so the samplers are held
to the same properties, not bits), plus the deterministic pieces
(``func_w``, ``entry``, ``V``, face assignment) against the JAX package."""

import jax
import numpy as np
import pytest
import torch

from xnode_wan_tpu.ops import sampling as jsampling
from xnode_wan_tpu_torch.ops.sampling import (Hypercube, PathBatch,
                                              stratified_times)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def cube():
    return Hypercube((-1.0, 1.0), dim=3, T0=0.0, T=1.0, N_t=10)


@pytest.fixture
def jcube():
    return jsampling.Hypercube((-1.0, 1.0), dim=3, T0=0.0, T=1.0, N_t=10)


@pytest.mark.parametrize("span,n", [((0.0, 1.0), 20), ((0.5, 2.5), 16),
                                    ((0.0, 1.0), 2)])
def test_stratified_times_gap_invariant(span, n):
    T0, T = span
    for seed in range(5):
        t = stratified_times(gen(seed), T0, T, n).numpy()
        assert t[0] == T0 and t[-1] == T
        assert np.all(np.diff(t) >= 0)
        assert np.max(np.diff(t)) <= 2 * (T - T0) / n + 1e-6
        # one draw per bin: sample i lies in [T0 + i h, T0 + (i+1) h]
        h = (T - T0) / n
        i = np.arange(1, n - 1)
        assert np.all(t[1:-1] >= T0 + i * h - 1e-6)
        assert np.all(t[1:-1] <= T0 + (i + 1) * h + 1e-6)


def test_cube_interior(cube):
    b = cube.interior(gen(), 64)
    assert isinstance(b, PathBatch)
    assert b.x.shape == (64, 10, 4) and b.x.dtype == torch.float32
    assert bool(b.mask.all())
    xs = b.space.numpy()
    assert xs.min() >= -1.0 and xs.max() <= 1.0
    assert np.allclose(xs, xs[:, :1, :])          # x frozen along the path
    ts = b.times.numpy()
    assert np.allclose(ts, ts[0])                 # one shared grid
    assert ts[0, 0] == 0.0 and ts[0, -1] == 1.0   # endpoints pinned
    assert bool(b.seed_from_h.all())
    assert bool((b.t_start == 0.0).all())


def test_cube_boundary_one_pinned_face_per_row(cube):
    n_b = 60
    b = cube.boundary(gen(1), n_b)
    xs = b.space[:, 0, :].numpy()
    pinned = np.isclose(np.abs(xs), 1.0)
    assert (pinned.sum(axis=-1) == 1).all()
    # faces round-robin i % 2d as in the JAX sampler: even -> top, odd -> bot
    face = np.arange(n_b) % (2 * cube.dim)
    rows = np.arange(n_b)
    np.testing.assert_array_equal(xs[rows, face // 2],
                                  np.where(face % 2 == 0, 1.0, -1.0))
    np.testing.assert_allclose(cube.func_w(b.x).numpy(), 0.0, atol=1e-6)


def test_cube_func_w_interior_positive(cube):
    b = cube.interior(gen(2), 128)
    assert bool((cube.func_w(b.x) > 0).all())


def test_func_w_entry_volume_match_jax(cube, jcube):
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(0, 1, (33, 7, 1)),
                        rng.uniform(-1, 1, (33, 7, 3))], axis=-1).astype(
                            np.float32)
    np.testing.assert_allclose(cube.func_w(torch.as_tensor(X)).numpy(),
                               np.asarray(jcube.func_w(X)), rtol=0, atol=0)
    pts = X[:, 0, :]
    t_t, h_t = cube.entry(torch.as_tensor(pts))
    t_j, h_j = jcube.entry(jax.numpy.asarray(pts))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    assert cube.V() == pytest.approx(jcube.V()) == pytest.approx(8.0)


def test_interior_uniform_moments():
    # the interior cloud is uniform on the box: mean (bot+top)/2, var w^2/12
    cube = Hypercube((-1.0, 3.0), dim=4, T0=0.0, T=1.0, N_t=4)
    xs = cube.interior(gen(3), 20000).space[:, 0, :].double().numpy()
    np.testing.assert_allclose(xs.mean(axis=0), 1.0, atol=0.05)
    np.testing.assert_allclose(xs.var(axis=0), 16.0 / 12.0, rtol=0.05)


def test_same_generator_same_batch_and_x64(cube):
    a, b = cube.interior(gen(5), 16), cube.interior(gen(5), 16)
    assert torch.equal(a.x, b.x)
    c64 = Hypercube((-1.0, 1.0), dim=3, T0=0.0, T=1.0, N_t=10, x64=True)
    b64 = c64.interior(gen(), 8)
    assert b64.x.dtype == torch.float64 and b64.t_start.dtype == torch.float64


def test_cube_rejections():
    with pytest.raises(ValueError, match="volume"):
        Hypercube((1.0, 1.0), dim=2, T0=0.0, T=1.0, N_t=4)
    # qmc: halton is no rejection: the cube draws its box from the cloud
    q = Hypercube((-1.0, 1.0), dim=2, T0=0.0, T=1.0, N_t=4, qmc="halton")
    xs = q.interior(gen(), 16).space[:, 0, :]
    assert float(xs.min()) >= -1.0 and float(xs.max()) < 1.0
