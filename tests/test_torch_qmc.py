"""The port's randomized-QMC clouds (``xnode_wan_tpu_torch/ops/qmc.py``)
and the Halton branches of its three domains, mirroring
``tests/test_qmc.py``.

``halton_base`` is deterministic numpy and is held bit for bit against the
JAX package's. The randomized draws take a ``torch.Generator`` where JAX
takes a key, so they are held by property: in range, unbiased, of lower
variance than i.i.d. draws at equal N, the domains' geometry exact.
"""

import tempfile

import numpy as np
import pytest
import torch

from xnode_wan_tpu.ops.qmc import halton_base as jhalton_base
from xnode_wan_tpu_torch import NODEWANSolver, SolverConfig, load_problem
from xnode_wan_tpu_torch.ops import qmc
from xnode_wan_tpu_torch.ops.sampling import (NSphereTCone,
                                              NSphereTHourglass, _ball,
                                              make_domain)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("n,dim", [(512, 7), (4000, 5), (300, 21)])
def test_halton_base_matches_jax_bitwise(n, dim):
    got = qmc.halton_base(n, dim)
    np.testing.assert_array_equal(got, jhalton_base(n, dim))
    assert got.dtype == np.float64 and got.shape == (n, dim)
    assert got.min() >= 0.0 and got.max() < 1.0
    # low discrepancy: every 1-D marginal is far more even than iid
    for j in range(dim):
        col = np.sort(got[:, j])
        gaps = np.diff(np.concatenate([[0.0], col, [1.0]]))
        assert gaps.max() < 20.0 / n


def test_qmc_uniform_generator_semantics():
    x1 = qmc.qmc_uniform(gen(0), 256, 5, torch.float32, -1.0, 1.0)
    x2 = qmc.qmc_uniform(gen(0), 256, 5, torch.float32, -1.0, 1.0)
    x3 = qmc.qmc_uniform(gen(1), 256, 5, torch.float32, -1.0, 1.0)
    assert x1.shape == (256, 5) and x1.dtype == torch.float32
    assert torch.equal(x1, x2) and not torch.allclose(x1, x3)
    assert float(x1.min()) >= -1.0 and float(x1.max()) < 1.0
    # the shift is the draw's only randomness: one d-vector from the
    # generator, added to the cached base modulo 1
    g = gen(4)
    shift = torch.rand((5,), generator=gen(4), dtype=torch.float64)
    base = torch.as_tensor(qmc.halton_base(64, 5))
    torch.testing.assert_close(
        qmc.qmc_uniform(g, 64, 5, torch.float64),
        torch.remainder(base + shift, 1.0), rtol=0, atol=0)
    # the base stays on the device per (n, dim, dtype, device): a second
    # draw copies nothing
    a = qmc._device_base(64, 5, torch.float64, torch.device("cpu"))
    assert qmc._device_base(64, 5, torch.float64, torch.device("cpu")) is a


def spread(draw, reps=32):
    return np.array([draw(i) for i in range(reps)])


def test_shifted_halton_is_unbiased_and_lower_variance():
    n, d = 1024, 5
    exact = d / 3.0   # the integral of sum x_i^2 over [0,1]^d
    q = spread(lambda i: float((qmc.qmc_uniform(
        gen(i), n, d, torch.float32) ** 2).sum(1).mean()))
    iid = spread(lambda i: float((torch.rand((n, d), generator=gen(i)) ** 2)
                                 .sum(1).mean()))
    assert abs(q.mean() - exact) < 3 * iid.std()
    assert q.std() < iid.std() / 3.0


def test_qmc_ball_unbiased_and_lower_variance():
    n, d, r = 1024, 3, 2.0
    exact = r * r * d / (d + 2)   # E |x|^2, uniform in the ball
    norms = []

    def q_draw(i):
        x = qmc.qmc_ball(gen(i), n, d, r, torch.float32)
        norms.append(float(torch.linalg.norm(x, dim=1).max()))
        return float((x ** 2).sum(1).mean())

    q = spread(q_draw)
    iid = spread(lambda i: float((_ball(gen(i), n, d, r) ** 2).sum(1).mean()))
    assert max(norms) <= r * (1 + 1e-6)
    assert abs(q.mean() - exact) < 3 * iid.std()
    assert q.std() < iid.std() / 3.0
    x = qmc.qmc_ball(gen(0), n, d, r, torch.float64)
    assert float(torch.linalg.norm(x, dim=1).min()) > 0.0   # off the origin
    assert torch.equal(x, qmc.qmc_ball(gen(0), n, d, r, torch.float64))


def test_qmc_time_sphere_and_guards():
    u, dirs = qmc.qmc_time_sphere(gen(2), 512, 4, torch.float64)
    assert u.shape == (512,) and dirs.shape == (512, 4)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    torch.testing.assert_close(torch.linalg.norm(dirs, dim=1),
                               torch.ones(512, dtype=torch.float64))
    gaps = np.diff(np.concatenate([[0.0], np.sort(u.numpy()), [1.0]]))
    assert gaps.max() < 20.0 / 512
    # the directions are unbiased: E[dir] = 0, E[dir_i^2] = 1/d
    q = spread(lambda i: float(qmc.qmc_time_sphere(
        gen(i), 1024, 3, torch.float32)[1][:, 0].mean()))
    iid = spread(lambda i: float(torch.nn.functional.normalize(
        torch.randn((1024, 3), generator=gen(i)), dim=1)[:, 0].mean()))
    assert abs(q.mean()) < 3 * iid.std() and q.std() < iid.std()
    with pytest.raises(ValueError, match="prime table"):
        qmc.halton_base(8, 52)
    with pytest.raises(ValueError, match="qmc"):
        SolverConfig(qmc="sobolev")
    for name, shape in (("Hypercube", (-1.0, 1.0)), ("NSphere_TCone", 1.0),
                        ("NSphere_THourglass", 1.0)):
        assert make_domain(name, shape, 3, 0.0, 1.0, 8,
                           qmc="halton").qmc == "halton"


def test_hypercube_interior_qmc_batch():
    dom = make_domain("Hypercube", (-1.0, 1.0), 5, 0.0, 1.0, 10, qmc="halton")
    batch = dom.interior(gen(3), 128)
    assert batch.x.shape == (128, 10, 6) and bool(batch.mask.all())
    xs = batch.space.numpy()
    assert xs.min() >= -1.0 and xs.max() < 1.0
    np.testing.assert_array_equal(xs[:, 0, :], xs[:, 5, :])
    t = batch.times[0].numpy()
    assert t[0] == 0.0 and t[-1] == 1.0 and (np.diff(t) > 0).all()
    assert not np.allclose(dom.interior(gen(4), 128).space.numpy(), xs)
    # per coordinate the mean is (bot + top) / 2 within the iid 4-sigma
    n = 4000
    x = dom.interior(gen(5), n).space[:, 0, :].double()
    assert (x.mean(0).abs() < 4 * (2.0 / 12 ** 0.5) / n ** 0.5).all()


def test_hypercube_boundary_qmc_batch():
    d = 3
    dom = make_domain("Hypercube", (-1.0, 1.0), d, 0.0, 1.0, 8, qmc="halton")
    n_b = 2 * d * 64
    batch = dom.boundary(gen(7), n_b)
    xs = batch.space[:, 0, :].numpy()
    face = (np.arange(n_b) * (2 * d)) // n_b   # contiguous blocks
    np.testing.assert_allclose(xs[np.arange(n_b), face // 2],
                               np.where(face % 2 == 0, 1.0, -1.0))
    np.testing.assert_array_equal(np.bincount(face), np.full(2 * d, 64))
    for f in range(2 * d):
        rows = xs[face == f]
        for j in range(d):
            if j == f // 2:
                continue
            col = np.sort(rows[:, j])
            gaps = np.diff(np.concatenate([[-1.0], col, [1.0]]))
            assert gaps.max() < 2.0 * 8.0 / len(rows)
    assert not np.allclose(dom.boundary(gen(8), n_b).space.numpy(),
                           batch.space.numpy())


def test_cone_interior_and_boundary_qmc():
    dom = NSphereTCone(1.0, 3, 0.0, 1.0, 8, qmc="halton")
    batch = dom.interior(gen(5), 128)
    rho = torch.linalg.norm(batch.space[:, 0, :], dim=-1).numpy()
    assert rho.max() <= 1.0 + 1e-6
    times = batch.x[0, :, 0].numpy()
    expect = times[None, :] < (1.0 - rho)[:, None]
    expect[:, 0] = True
    np.testing.assert_array_equal(batch.mask.numpy(), expect)
    assert not np.allclose(dom.interior(gen(6), 128).space.numpy(),
                           batch.space.numpy())
    # boundary: on the moving boundary, the time marginal even
    n_b, d1 = 512, 4
    pts = NSphereTCone(1.0, 3, 0.0, 1.0, 8, path_boundary=False,
                       qmc="halton").boundary(gen(9), n_b)
    t, xs = pts.x[:, 0, 0].numpy(), pts.x[:, 0, 1:].numpy()
    np.testing.assert_allclose(np.linalg.norm(xs, axis=-1), 1.0 - t,
                               atol=1e-5)
    u = 1.0 - (1.0 - t) ** d1   # the forward CDF
    assert np.diff(np.concatenate([[0.0], np.sort(u), [1.0]])).max() \
        < 20.0 / n_b
    # with boundary paths (the default), each path ends on the boundary
    b = dom.boundary(gen(10), 64)
    torch.testing.assert_close(dom.func_w(b.x[:, -1, :]),
                               torch.zeros(64), atol=1e-5, rtol=0)


def test_hourglass_qmc():
    dom = NSphereTHourglass(1.0, 3, 0.0, 1.0, 8, path_boundary=False,
                            qmc="halton")
    b = dom.boundary(gen(11), 256)
    t, xs = b.x[:, 0, 0], b.x[:, 0, 1:]
    torch.testing.assert_close(torch.linalg.norm(xs, dim=-1),
                               dom.radius_at(t), atol=1e-5, rtol=0)
    assert bool((t < 0.5).any()) and bool((t > 0.5).any())
    ib = dom.interior(gen(12), 64)
    assert ib.x.shape[0] == 128
    assert float(torch.linalg.norm(ib.space[:, 0, :], dim=-1).max()) \
        <= 1.0 + 1e-6
    assert bool(ib.seed_from_h[:64].all()) and not bool(
        ib.seed_from_h[64:].any())


@pytest.mark.parametrize("domain,shape", [("Hypercube", (-1.0, 1.0)),
                                          ("NSphere_TCone", 1.0)])
def test_qmc_outer_step(domain, shape):
    # one real outer step with qmc: halton at d = 2 on the CPU
    cfg = SolverConfig(dim=2, N_t=6, N_r=32, N_b=32, u_hidden_dim=8,
                       u_hidden_hidden_dim=8, u_layers=2, v_layers=2,
                       v_hidden_dim=12, min_steps=2, qmc="halton",
                       domain=domain, shape_param=shape)
    with tempfile.TemporaryDirectory() as work:
        s = NODEWANSolver(cfg, load_problem("Ex4_1_funcs", dim=2),
                          device="cpu", work_dir=work)
        before = [p.detach().clone() for p in s.state.u_params.parameters()]
        m = s._to_host(s._outer_step())
    assert s.state.step == 1
    assert all(np.isfinite(m[k]) for k in ("loss_u", "loss_v", "rel_err"))
    assert any(not torch.equal(a, p) for a, p in
               zip(before, s.state.u_params.parameters()))
