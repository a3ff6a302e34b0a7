"""repro_torch's solvers against the JAX package's, end to end on the CPU.

The same numpy arrays build a JAX problem directly and a port problem
through ``repro_torch.convert`` (``device="cpu"``). The JAX side solves on
its default XLA operators; the port runs its fused plan (the kernels'
plain versions on CPU tensors) or, with ``use_pallas=False``, its plain
torch operators. The bar: cost rtol 1e-5, potentials atol 1e-5 on live
atoms, -inf on dead atoms, |d n_iter| <= 1 (the Gaussian feature map may
differ from the XLA one in the last ulp).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.divergence import sinkhorn_divergence_geometry as j_div
from repro.core.features import GaussianFeatureMap
from repro.core.geometry import GaussianPointCloud as JGaussian
from repro.core.sinkhorn import sinkhorn_log_geometry as j_log_solve
from repro_torch import convert
from repro_torch.core import (
    EpsSchedule,
    sinkhorn_divergence_geometry,
    sinkhorn_log_geometry,
    solve,
)
from repro_torch.kernels.ops import observe_plan_selection

N, M, D, R_ANCH, EPS = 120, 100, 3, 32, 0.5


def _clouds(seed=0, n=N, m=M, d=D, r=R_ANCH, eps=EPS):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 1.0).astype(np.float32)
    y = (math.sqrt(0.1) * rng.standard_normal((m, d))).astype(np.float32)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    fm = GaussianFeatureMap(r=r, d=d, eps=eps, R=R)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((r, d))).astype(np.float32)
    return x, y, u, R


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _assert_match(tres, jres, *, cost_rtol=1e-5, pot_atol=1e-5, a=None,
                  b=None):
    assert float(tres.cost) == pytest.approx(float(jres.cost), rel=cost_rtol)
    assert abs(int(tres.n_iter) - int(jres.n_iter)) <= 1
    for t_pot, j_pot, w in ((tres.f, jres.f, a), (tres.g, jres.g, b)):
        j_pot = np.asarray(j_pot)
        t_pot = t_pot.numpy()
        live = np.ones(j_pot.shape, bool) if w is None else np.asarray(w) > 0
        np.testing.assert_allclose(t_pot[live], j_pot[live], atol=pot_atol,
                                   rtol=0)
        assert np.all(t_pot[~live] == -np.inf)
        assert np.all(j_pot[~live] == -np.inf)


@pytest.fixture(scope="module")
def clouds():
    return _clouds()


@pytest.fixture(scope="module")
def jax_gaussian(clouds):
    x, y, u, R = clouds
    prob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=EPS, R=R)
    return japi.solve(prob)


def _port_gaussian(clouds, **kw):
    x, y, u, R = clouds
    geom = convert.gaussian_point_cloud(x, y, u, eps=EPS, R=R, device="cpu")
    return convert.ot_problem(geom, device="cpu", **kw)


def test_log_factored_gaussian_plan_matches_jax(clouds, jax_gaussian):
    res = solve(_port_gaussian(clouds))
    _assert_match(res, jax_gaussian)
    assert bool(res.converged) and not bool(res.diverged)


def test_log_factored_gaussian_plain_operators_match_jax(clouds,
                                                         jax_gaussian):
    res = solve(_port_gaussian(clouds), use_pallas=False)
    _assert_match(res, jax_gaussian)


def test_forced_plan_is_observed(clouds):
    with observe_plan_selection() as events:
        solve(_port_gaussian(clouds), use_pallas=True, max_iter=3)
    assert events == [{"geometry": "GaussianPointCloud", "mode": "log",
                       "kind": "gaussian", "precision": "highest"}]
    with observe_plan_selection() as events:
        solve(_port_gaussian(clouds), use_pallas=False, max_iter=3)
    assert events == []


def _log_features(seed=3, n=90, m=70, r=24):
    rng = np.random.default_rng(seed)
    lxi = (rng.standard_normal((n, r)) - 1.0).astype(np.float32)
    lzt = (rng.standard_normal((m, r)) - 1.0).astype(np.float32)
    return lxi, lzt


@pytest.mark.parametrize("use_pallas", [None, False])
def test_explicit_log_features_match_jax(use_pallas):
    lxi, lzt = _log_features()
    jres = japi.solve(japi.OTProblem.from_log_features(_j(lxi), _j(lzt),
                                                       eps=0.7))
    geom = convert.factored_positive(log_xi=lxi, log_zeta=lzt, eps=0.7,
                                     device="cpu")
    res = solve(convert.ot_problem(geom, device="cpu"), use_pallas=use_pallas)
    _assert_match(res, jres)


def test_explicit_linear_features_factored_match_jax():
    lxi, lzt = _log_features(seed=4)
    xi, zeta = np.exp(lxi), np.exp(lzt)
    jres = japi.solve(japi.OTProblem.from_features(_j(xi), _j(zeta),
                                                   eps=0.7))
    geom = convert.factored_positive(xi=xi, zeta=zeta, eps=0.7, device="cpu")
    res = solve(convert.ot_problem(geom, device="cpu"), method="factored",
                use_pallas=False)
    _assert_match(res, jres)


def test_linear_features_through_the_log_plan_match_jax():
    """``factored`` specs reach the log plan through the masked log."""
    lxi, lzt = _log_features(seed=5)
    xi, zeta = np.exp(lxi), np.exp(lzt)
    jres = japi.solve(japi.OTProblem.from_features(_j(xi), _j(zeta),
                                                   eps=0.7),
                      method="log_factored")
    geom = convert.factored_positive(xi=xi, zeta=zeta, eps=0.7, device="cpu")
    with observe_plan_selection() as events:
        res = solve(convert.ot_problem(geom, device="cpu"),
                    method="log_factored")
    assert [e["kind"] for e in events] == ["factored"]
    _assert_match(res, jres)


@pytest.mark.parametrize("method", ["quadratic", "log_quadratic"])
def test_quadratic_methods_match_jax(clouds, method):
    x, y, u, R = clouds
    x, y = x[:60], y[:50]
    jprob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=EPS,
                                             R=R)
    jres = japi.solve(jprob, method=method)
    geom = convert.gaussian_point_cloud(x, y, u, eps=EPS, R=R, device="cpu")
    res = solve(convert.ot_problem(geom, device="cpu"), method=method)
    _assert_match(res, jres)


def test_zero_weight_atoms_match_jax(clouds):
    x, y, u, R = clouds
    a = np.full(N, 1.0, np.float32)
    a[[0, 7, 50]] = 0.0
    a /= a.sum()
    b = np.full(M, 1.0, np.float32)
    b[[3, 99]] = 0.0
    b /= b.sum()
    jprob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), _j(a),
                                             _j(b), eps=EPS, R=R)
    jres = japi.solve(jprob)
    res = solve(_port_gaussian(clouds, a=a, b=b))
    _assert_match(res, jres, a=a, b=b)
    assert not bool(res.diverged)


def test_momentum_matches_jax(clouds):
    """Over-relaxed solve at a tolerance it reaches (at 1e-6 the w = 1.3
    iteration stalls at the float32 noise floor in both packages, where
    rounding drifts the potentials' free additive constant)."""
    x, y, u, R = clouds
    jprob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=EPS,
                                             R=R)
    jres = japi.solve(jprob, momentum=1.3, tol=1e-5)
    res = solve(_port_gaussian(clouds), momentum=1.3, tol=1e-5)
    assert bool(res.converged) and res.n_iter < 100
    _assert_match(res, jres)


def test_warm_start_matches_jax(clouds):
    x, y, u, R = clouds
    rng = np.random.default_rng(9)
    f0 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    g0 = (0.1 * rng.standard_normal(M)).astype(np.float32)
    jgeom = JGaussian.build(_j(x), _j(y), _j(u), eps=EPS, R=R)
    a, b = jnp.full((N,), 1.0 / N), jnp.full((M,), 1.0 / M)
    jres = j_log_solve(jgeom, a, b, f_init=_j(f0), g_init=_j(g0))
    prob = _port_gaussian(clouds)
    res = sinkhorn_log_geometry(prob.geometry, prob.a, prob.b,
                                f_init=torch.as_tensor(f0),
                                g_init=torch.as_tensor(g0))
    _assert_match(res, jres)


def test_eps_schedule_cascade_matches_jax(clouds):
    x, y, u, R = clouds
    jprob = japi.OTProblem.from_point_clouds(_j(x), _j(y), _j(u), eps=0.2,
                                             R=R)
    jann = japi.solve_annealed(jprob, schedule=japi.EpsSchedule(
        eps_init=1.0, decay=0.5))
    geom = convert.gaussian_point_cloud(x, y, u, eps=0.2, R=R, device="cpu")
    from repro_torch.core import solve_annealed
    ann = solve_annealed(convert.ot_problem(geom, device="cpu"),
                         schedule=EpsSchedule(eps_init=1.0, decay=0.5))
    assert ann.stage_eps == tuple(jann.stage_eps)
    assert all(abs(a - int(b)) <= 1
               for a, b in zip(ann.stage_iters, np.asarray(jann.stage_iters)))
    _assert_match(ann.result, jann.result)
    res = solve(convert.ot_problem(geom, device="cpu"),
                schedule=EpsSchedule(eps_init=1.0, decay=0.5))
    assert float(res.cost) == float(ann.result.cost)


def test_divergence_matches_jax(clouds):
    x, y, u, R = clouds
    jgeom = JGaussian.build(_j(x), _j(y), _j(u), eps=EPS, R=R)
    want = float(j_div(jgeom))
    geom = convert.gaussian_point_cloud(x, y, u, eps=EPS, R=R, device="cpu")
    got = sinkhorn_divergence_geometry(geom)
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-5)
    plain = sinkhorn_divergence_geometry(geom, use_pallas=False)
    assert float(plain) == pytest.approx(want, rel=1e-5)


def test_check_every_cadence_matches_jax(clouds):
    """An explicit cadence checks the error every 4 iterations: n_iter is
    a multiple of 4 on both sides."""
    x, y, u, R = clouds
    jgeom = JGaussian.build(_j(x), _j(y), _j(u), eps=EPS, R=R)
    a, b = jnp.full((N,), 1.0 / N), jnp.full((M,), 1.0 / M)
    jres = j_log_solve(jgeom, a, b, check_every=4)
    prob = _port_gaussian(clouds)
    res = sinkhorn_log_geometry(prob.geometry, prob.a, prob.b, check_every=4)
    assert res.n_iter % 4 == 0 and res.n_iter == int(jres.n_iter)
    _assert_match(res, jres)
    with pytest.raises(ValueError, match="multiple"):
        sinkhorn_log_geometry(prob.geometry, prob.a, prob.b, inner_steps=3,
                              check_every=4)
