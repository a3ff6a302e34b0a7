"""repro_torch's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX kernel (interpret mode, as
tests/test_kernels.py runs it) and through the port's wrapper on CPU
tensors, where it runs the kernel's plain PyTorch version. The CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py. Tolerances are the ones tests/test_kernels.py holds the
Pallas kernels to: rtol 2e-4 / atol 1e-6 for the feature map, rtol 1e-4 /
atol 1e-4 for the LSE kernels; the scaling kernels, whose own comparisons
are in tests/test_torch_scaling.py, within 1e-5 of max |value|.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.kernels import (
    fused_log_sinkhorn_iteration as j_iteration,
    fused_sinkhorn_iteration as j_scaling_iteration,
    gaussian_feature_map as j_feature_map,
    log_feature_contract as j_contract,
    log_halfstep as j_halfstep,
)
from repro_torch.core import features as tfeat
from repro_torch.kernels import (
    feature_contract,
    feature_matvec,
    gaussian_feature_map,
    launch_counts,
    log_feature_contract,
    log_halfstep,
    ref,
    sinkhorn_halfstep,
)
from repro_torch.kernels.ops import _log_plan, fused_sinkhorn_iteration

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _feature_inputs(n, r, d, eps, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 1.0).astype(np.float32)
    R = float(np.max(np.linalg.norm(x, axis=1)))
    q = jfeat.gaussian_q(R, eps, d)
    u = (math.sqrt(q * eps / 4.0)
         * rng.standard_normal((r, d))).astype(np.float32)
    c = (0.25 * d * np.log(2 * q) + np.sum(u * u, 1) / (q * eps)
         - 0.5 * np.log(r)).astype(np.float32)
    return x, u, c


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("n,r,d,eps", [
    (17, 3, 2, 0.6), (130, 60, 5, 0.3), (257, 64, 8, 1.0),
])
def test_feature_map_matches_pallas(n, r, d, eps, log_space):
    x, u, c = _feature_inputs(n, r, d, eps, n + r)
    want = j_feature_map(jnp.asarray(x), jnp.asarray(u), jnp.asarray(c),
                         inv_eps=1 / eps, log_space=log_space,
                         backend="interpret")
    got = gaussian_feature_map(_t(x), _t(u), _t(c), inv_eps=1 / eps,
                               log_space=log_space)
    assert got.shape == (n, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("log_space", [True, False])
def test_feature_map_neg_inf_log_const(log_space):
    """A -inf log-constant (a padded anchor) gives exactly -inf, or exactly
    0 in linear space, never NaN."""
    x, u, c = _feature_inputs(31, 7, 3, 0.5, 3)
    c[[2, 5]] = -np.inf
    want = np.asarray(j_feature_map(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(c), inv_eps=2.0,
        log_space=log_space, backend="interpret"))
    got = gaussian_feature_map(_t(x), _t(u), _t(c), inv_eps=2.0,
                               log_space=log_space).numpy()
    dead = -np.inf if log_space else 0.0
    assert np.all(got[:, [2, 5]] == dead)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def _log_inputs(n, m, r, B, seed, neg_inf):
    rng = np.random.default_rng(seed)
    lw_n = (3.0 * rng.standard_normal((n, r))).astype(np.float32)
    lw_m = (3.0 * rng.standard_normal((m, r))).astype(np.float32)
    s = (2.0 * rng.standard_normal((n, B))).astype(np.float32)
    t = (2.0 * rng.standard_normal((r, B))).astype(np.float32)
    lmarg = rng.standard_normal((m, B)).astype(np.float32)
    if neg_inf:
        lw_n[n // 3, :] = -np.inf           # a dead feature row
        lw_n[:, r // 2] = -np.inf           # a dead anchor column
        lw_m[m // 4, :] = -np.inf
        s[n // 5, :] = -np.inf              # dead atoms carry f = -inf
        t[r // 3, 0] = -np.inf
    return lw_n, lw_m, s, t, lmarg


LOG_SHAPES = [
    (17, 13, 3, 1, False), (130, 77, 60, 3, False), (300, 255, 64, 1, False),
    (41, 29, 5, 3, True), (64, 50, 33, 1, True),
]


@pytest.mark.parametrize("n,m,r,B,neg_inf", LOG_SHAPES)
def test_log_feature_contract_matches_pallas(n, m, r, B, neg_inf):
    lw_n, _, s, _, _ = _log_inputs(n, m, r, B, n * 7 + r, neg_inf)
    want = np.asarray(j_contract(jnp.asarray(lw_n), jnp.asarray(s),
                                 backend="interpret"))
    got = log_feature_contract(_t(lw_n), _t(s)).numpy()
    assert got.shape == (r, B)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale", [0.37, -1.0])
@pytest.mark.parametrize("n,m,r,B,neg_inf", LOG_SHAPES)
def test_log_halfstep_matches_pallas(n, m, r, B, neg_inf, scale):
    _, lw_m, _, t, lmarg = _log_inputs(n, m, r, B, m * 5 + r, neg_inf)
    if scale == -1.0:
        lmarg = np.zeros_like(lmarg)        # the raw LSE of the error check
    want = np.asarray(j_halfstep(jnp.asarray(lw_m), jnp.asarray(t),
                                 jnp.asarray(lmarg), scale=scale,
                                 backend="interpret"))
    got = log_halfstep(_t(lw_m), _t(t), _t(lmarg), scale=scale).numpy()
    assert got.shape == (m, B)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_all_neg_inf_column_gives_neg_inf():
    """A column of s that is all -inf contracts to -inf, not NaN (the
    _finite_or_zero pin)."""
    lw = np.random.default_rng(0).standard_normal((9, 4)).astype(np.float32)
    s = np.full((9, 2), -np.inf, np.float32)
    s[:, 0] = 0.5
    got = log_feature_contract(_t(lw), _t(s)).numpy()
    assert np.all(np.isfinite(got[:, 0])) and np.all(got[:, 1] == -np.inf)
    want = np.asarray(j_contract(jnp.asarray(lw), jnp.asarray(s),
                                 backend="interpret"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fused_log_iteration_matches_pallas():
    """One full plan iteration (two contracts, two half-steps) against the
    JAX package's fused log iteration in interpret mode."""
    n, m, r, B, eps = 40, 30, 16, 3, 0.5
    rng = np.random.default_rng(2)
    lxi = rng.standard_normal((n, r)).astype(np.float32)
    lzt = rng.standard_normal((m, r)).astype(np.float32)
    loga = np.log(np.full((n, B), 1.0 / n, np.float32))
    logb = np.log(np.full((m, B), 1.0 / m, np.float32))
    f = rng.standard_normal((n, B)).astype(np.float32)
    jf, jg = j_iteration(jnp.asarray(lxi), jnp.asarray(lzt),
                         jnp.asarray(loga), jnp.asarray(logb),
                         jnp.asarray(f), eps=eps, backend="interpret")
    plan = _log_plan("log_factored", _t(lxi), _t(lzt), eps)
    tf, tg = plan.iteration(_t(loga), _t(logb), _t(f))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4,
                               atol=1e-5)


def test_fused_scaling_iteration_matches_pallas():
    """One full scaling iteration (two contracts, two fused half-steps)
    against the JAX package's in interpret mode, within 1e-5 of max
    |value|."""
    n, m, r, B = 40, 30, 16, 3
    rng = np.random.default_rng(1)
    xi = (rng.uniform(size=(n, r)) + 0.05).astype(np.float32)
    zt = (rng.uniform(size=(m, r)) + 0.05).astype(np.float32)
    a = np.full((n, B), 1.0 / n, np.float32)
    b = np.full((m, B), 1.0 / m, np.float32)
    u = rng.uniform(size=(n, B)).astype(np.float32)
    jout = j_scaling_iteration(*(jnp.asarray(x) for x in (xi, zt, a, b, u)),
                               backend="interpret")
    tout = fused_sinkhorn_iteration(*(_t(x) for x in (xi, zt, a, b, u)))
    for got, want in zip(tout, jout):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(
            np.abs(want))


@pytest.mark.parametrize("z", [1e-6, 0.3, 1.0, math.e, 7.5, 56.25, 4e4])
def test_lambert_w0_matches_jax(z):
    assert tfeat.lambert_w0(z) == pytest.approx(jfeat.lambert_w0(z),
                                                rel=1e-12)


@pytest.mark.parametrize("R,eps,d", [(0.0, 0.1, 2), (3.0, 0.5, 2),
                                     (6.5, 0.1, 8), (1.0, 2.0, 28)])
def test_gaussian_q_matches_jax(R, eps, d):
    assert tfeat.gaussian_q(R, eps, d) == pytest.approx(
        jfeat.gaussian_q(R, eps, d), rel=1e-12)


@pytest.mark.parametrize("eps", [0.1, 1.0])
def test_gaussian_log_features_matches_jax(eps):
    x, u, _ = _feature_inputs(50, 24, 4, eps, 11)
    q = jfeat.gaussian_q(4.0, eps, 4)
    want = np.asarray(jfeat.gaussian_log_features(
        jnp.asarray(x), jnp.asarray(u), eps=eps, q=q))
    got = tfeat.gaussian_log_features(_t(x), _t(u), eps=eps, q=q).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_feature_map_anchor_sampler_has_lemma1_variance():
    fm = tfeat.GaussianFeatureMap(r=4096, d=3, eps=0.5, R=2.0)
    u = fm.init(torch.Generator().manual_seed(0))
    assert u.shape == (4096, 3) and u.dtype == torch.float32
    assert float(u.var()) == pytest.approx(fm.sigma2, rel=0.05)
    assert fm.sigma2 == pytest.approx(
        jfeat.GaussianFeatureMap(r=4096, d=3, eps=0.5, R=2.0).sigma2,
        rel=1e-12)


def test_cpu_wrappers_run_plain_versions_without_launching():
    x, u, c = _feature_inputs(20, 6, 3, 0.5, 1)
    before = launch_counts()
    got = gaussian_feature_map(_t(x), _t(u), _t(c), inv_eps=2.0,
                               log_space=True)
    want = ref.gaussian_feature_map_ref(_t(x), _t(u), _t(c), inv_eps=2.0,
                                        log_space=True)
    assert torch.equal(got, want)
    assert launch_counts() == before


def test_wrappers_check_operands():
    lw = torch.zeros((8, 4))
    with pytest.raises(TypeError):
        log_feature_contract(lw.double(), torch.zeros((8, 1)).double())
    with pytest.raises(ValueError):
        log_feature_contract(lw, torch.zeros((7, 1)))
    with pytest.raises(ValueError):
        log_halfstep(torch.zeros((4, 8)).T, torch.zeros((8, 1)),
                     torch.zeros((4, 1)))


def test_scaling_wrappers_check_operands_and_launch_nothing_on_cpu():
    before = launch_counts()
    xi, t = torch.ones((8, 4)), torch.ones((4, 1))
    feature_matvec(xi, t)
    feature_contract(xi, torch.ones((8, 2)))
    assert launch_counts() == before
    with pytest.raises(TypeError):
        feature_contract(xi.double(), torch.ones((8, 1)).double())
    with pytest.raises(ValueError):
        feature_contract(xi, torch.ones((7, 1)))
    with pytest.raises(ValueError):
        sinkhorn_halfstep(xi, t, torch.ones((8, 2)))
    with pytest.raises(ValueError):
        feature_matvec(torch.ones((4, 8)).T, torch.ones((4, 1)))


@pytest.mark.parametrize("dtype,r,B,want", [
    (torch.bfloat16, 128, 1, False),   # 16 vectors a row: most of a CTA idle
    (torch.float32, 128, 1, False),
    (torch.bfloat16, 1024, 1, True),   # 128 vectors fill the CTA
    (torch.float32, 512, 1, True),
    (torch.bfloat16, 1028, 1, False),  # rows not on 16-byte boundaries
    (torch.float32, 1024, 2, False),   # the vector path takes B = 1 only
])
def test_contract_takes_vector_path_only_where_it_fills_a_cta(dtype, r, B,
                                                              want):
    from repro_torch.kernels.logmatvec import _contract_vectorized
    assert _contract_vectorized(torch.empty((64, r), dtype=dtype), B) is want
