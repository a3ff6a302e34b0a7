"""repro_torch's training slice against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port (``device="cpu"``, where every kernel runs its plain PyTorch
version). The JAX side runs with ``use_pallas=True`` and explicit
``inner_steps=8`` where the megakernel is meant, so its
``log_sinkhorn_block_pallas`` runs in interpret mode. Tolerances: the
megakernel's plain version potentials atol 1e-5, and its block-end error
rtol 1e-5 with atol 2e-6: that error is an L1 distance between unit-mass
marginals, which moves by about the potentials' difference (summation
order differs), so where it is small the absolute term holds it (the
largest gap over the cases is 1.6e-6, bf16 at momentum 1.3 and B = 1,
where the error is 1.08e-3);
bf16 solves cost rtol 1e-4 against JAX at bf16 (never against float32);
the divergence value rtol 1e-5 and gradients rtol 1e-4 / atol 1e-7, the
bounds of ``tests/test_objective.py``; one trainer step's updated
parameters within 1e-4 of their layer's max |value| (weight and bias
together: the biases start at 0, so alone they hold only lr * gradient).
"""
import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.features import GaussianFeatureMap as JFeatureMap
from repro.core.geometry import FactoredPositive as JFactored
from repro.core.geometry import GaussianPointCloud as JGaussian
from repro.core.objective import ExecutionPolicy as JPolicy
from repro.core.objective import OTObjective as JObjective
from repro.core.sinkhorn import _resolve_cadence as j_resolve_cadence
from repro.core.sinkhorn import sinkhorn_log_geometry as j_log_solve
from repro.kernels.backend import resolve_backend
from repro.kernels.fused_loop import block_plan_fits as j_block_plan_fits
from repro.kernels.fused_loop import log_sinkhorn_block_pallas
from repro_torch import convert
from repro_torch.core import ExecutionPolicy, OTObjective, sinkhorn_log_geometry
from repro_torch.core.sinkhorn import _resolve_cadence
from repro_torch.examples import ot_gan
from repro_torch.kernels import ref
from repro_torch.kernels.fused_loop import block_plan_fits, log_sinkhorn_block
from repro_torch.kernels.ops import observe_plan_selection

ROOT = Path(__file__).resolve().parents[1]


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _clouds(seed, n, m, d, r, eps):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 1.0).astype(np.float32)
    y = (0.5 * rng.standard_normal((m, d))).astype(np.float32)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    fm = JFeatureMap(r=r, d=d, eps=eps, R=R)
    u = (math.sqrt(fm.sigma2) * rng.standard_normal((r, d))).astype(np.float32)
    return x, y, u, R


def _masked_log(w):
    with np.errstate(divide="ignore"):
        return np.where(w > 0, np.log(np.where(w > 0, w, 1.0)), -np.inf)


# ---------------------------------------------------------------------------
# The megakernel's plain version against log_sinkhorn_block_pallas
# ---------------------------------------------------------------------------


def _block_inputs(B, seed=0, n=24, m=18, r=16, eps=0.5):
    """Log-features of two clouds, B weight columns with a zero-weight atom
    in each, and the carry the plan starts a block from."""
    x, y, u, R = _clouds(seed, n, m, 3, r, eps)
    g = JGaussian(x=_j(x), y=_j(y), anchors=_j(u), eps=eps, R=R)
    lxi, lzt = (np.asarray(v) for v in g.log_features())
    rng = np.random.default_rng(seed + 1)
    a = rng.uniform(0.5, 1.5, (n, B)).astype(np.float32)
    b = rng.uniform(0.5, 1.5, (m, B)).astype(np.float32)
    a[3, :] = 0.0
    b[5, 0] = 0.0
    a, b = a / a.sum(0), b / b.sum(0)
    loga, logb = _masked_log(a), _masked_log(b)
    f0 = np.where(a > 0, 0.1 * rng.standard_normal((n, B)), -np.inf)
    g0 = np.where(b > 0, 0.1 * rng.standard_normal((m, B)), -np.inf)
    f0, g0 = f0.astype(np.float32), g0.astype(np.float32)
    t0 = ref.log_feature_contract_ref(_t(lxi), _t(f0) / eps).numpy()
    return lxi, lzt, loga, logb, b, f0, g0, t0, eps


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("momentum", [1.0, 1.3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_ref_matches_pallas(dtype, momentum, B):
    lxi, lzt, loga, logb, b, f0, g0, t0, eps = _block_inputs(B)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    want = log_sinkhorn_block_pallas(
        _j(lxi, jdt), _j(lzt, jdt), _j(loga), _j(logb), _j(b), _j(f0),
        _j(g0), _j(t0), inner_steps=8, eps=eps, momentum=momentum,
        interpret=True)
    got = log_sinkhorn_block(
        _t(lxi, tdt), _t(lzt, tdt), _t(loga), _t(logb), _t(b), _t(f0),
        _t(g0), _t(t0), inner_steps=8, eps=eps, momentum=momentum)
    for gv, wv in zip(got[:3], want[:3]):
        gv, wv = gv.numpy(), np.asarray(wv)
        live = np.isfinite(wv)
        assert np.array_equal(np.isfinite(gv), live)
        assert np.all(gv[~live] == wv[~live])
        np.testing.assert_allclose(gv[live], wv[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5,
                               atol=2e-6)


def test_block_ref_dead_anchor_column_gives_minus_inf_not_nan():
    lxi, lzt, loga, logb, b, f0, g0, t0, eps = _block_inputs(1)
    lxi, lzt = lxi.copy(), lzt.copy()
    lxi[:, 2] = -np.inf
    lzt[:, 2] = -np.inf
    t0 = ref.log_feature_contract_ref(_t(lxi), _t(f0) / eps).numpy()
    f, g, t, err = log_sinkhorn_block(
        _t(lxi), _t(lzt), _t(loga), _t(logb), _t(b), _t(f0), _t(g0), _t(t0),
        inner_steps=8, eps=eps, momentum=1.3)
    assert float(t[2, 0]) == -math.inf
    assert not any(torch.isnan(v).any() for v in (f, g, t))
    assert math.isfinite(float(err))


# ---------------------------------------------------------------------------
# bf16 storage: the log plan and the plain operators against JAX at bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas,inner_steps", [
    (True, None), (True, 8), (False, None)])
def test_bf16_solve_matches_jax_bf16(use_pallas, inner_steps):
    eps = 0.5
    x, y, u, R = _clouds(3, 60, 50, 3, 24, eps)
    a = np.full(60, 1 / 60, np.float32)
    b = np.full(50, 1 / 50, np.float32)
    kw = dict(tol=1e-5, max_iter=200, use_pallas=use_pallas,
              inner_steps=inner_steps, precision="bf16")
    jres = j_log_solve(JGaussian(x=_j(x), y=_j(y), anchors=_j(u), eps=eps,
                                 R=R), _j(a), _j(b), **kw)
    geom = convert.gaussian_point_cloud(x, y, u, eps=eps, R=R, device="cpu")
    res = sinkhorn_log_geometry(geom, _t(a), _t(b), **kw)
    assert float(res.cost) == pytest.approx(float(jres.cost), rel=1e-4)
    assert abs(res.n_iter - int(jres.n_iter)) <= (inner_steps or 1)


def test_bf16_factors_are_stored_in_bf16_and_differ_from_f32():
    eps = 0.5
    x, y, u, R = _clouds(4, 30, 20, 2, 12, eps)
    geom = convert.gaussian_point_cloud(x, y, u, eps=eps, R=R, device="cpu")
    from repro_torch.kernels.ops import geometry_ops
    plan = geometry_ops(geom, mode="log", precision="bf16")
    assert plan.features[0].dtype == torch.bfloat16
    a, b = _t(np.full(30, 1 / 30)), _t(np.full(20, 1 / 20))
    c16 = sinkhorn_log_geometry(geom, a, b, precision="bf16", tol=1e-5)
    c32 = sinkhorn_log_geometry(geom, a, b, tol=1e-5)
    assert float(c16.cost) != float(c32.cost)
    assert float(c16.cost) == pytest.approx(float(c32.cost), rel=1e-2)


# ---------------------------------------------------------------------------
# Megakernel admission and the auto cadence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,r,dtype", [
    (256, 256, 128, "bf16"),      # the OT-GAN example: admitted
    (256, 256, 128, "f32"),       # refused: 262,144 B of factors
    (512, 512, 128, "bf16"),      # bench_gan's smallest batch: refused
    (2048, 2048, 128, "bf16"),    # bench_gan's largest: refused
    (176, 176, 128, "f32"),
    (20, 24, 1100, "bf16"),
    (100, 37, 5, "f32"),
])
def test_block_admission_matches_jax_gpu_budget(n, m, r, dtype):
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    want = j_block_plan_fits(n, m, r, 1, jdt,
                             backend=resolve_backend("gpu-triton"))
    assert block_plan_fits(n, m, r, 1, tdt) == want


def test_auto_cadence_matches_jax():
    block = lambda *a, **k: None  # noqa: E731
    compiled = types.SimpleNamespace(interpret=False, make_block_step=block)
    interp = types.SimpleNamespace(interpret=True, make_block_step=block)
    on_card = types.SimpleNamespace(
        features=(types.SimpleNamespace(is_cuda=True),),
        make_block_step=block)
    on_cpu = types.SimpleNamespace(features=(torch.zeros(1),),
                                   make_block_step=block)
    assert _resolve_cadence(on_card, None, None) == \
        j_resolve_cadence(compiled, None, None) == (8, 8, True)
    assert _resolve_cadence(on_cpu, None, None) == \
        j_resolve_cadence(interp, None, None) == (1, 1, True)
    assert _resolve_cadence(None, None, None) == \
        j_resolve_cadence(None, None, None)
    assert _resolve_cadence(on_cpu, 8, 16) == \
        j_resolve_cadence(interp, 8, 16) == (8, 16, False)


# ---------------------------------------------------------------------------
# OTObjective: value and envelope gradient against JAX
# ---------------------------------------------------------------------------


def _objective_case(kind, zero_weight):
    eps = 0.8
    x, y, u, R = _clouds(7, 24, 18, 2, 48, eps)
    a = np.full(24, 1 / 24, np.float32)
    b = np.full(18, 1 / 18, np.float32)
    if zero_weight:
        a[4], b[2] = 0.0, 0.0
        a, b = a / a.sum(), b / b.sum()
    if kind == "gaussian":
        args = (x, y, u)
    else:
        g = JGaussian(x=_j(x), y=_j(y), anchors=_j(u), eps=eps, R=R)
        args = tuple(np.asarray(v) for v in g.log_features())
    return eps, R, args, a, b


@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("kind,zero_weight", [
    ("gaussian", False), ("gaussian", True), ("factored", False),
    ("factored", True)])
def test_objective_divergence_and_gradient_match_jax(kind, zero_weight,
                                                      use_pallas):
    eps, R, args, a, b = _objective_case(kind, zero_weight)
    # the port's fused plan against the JAX package's (interpret mode), its
    # plain operators against the JAX package's XLA operators
    jobj = JObjective(eps=eps, tol=0.0, max_iter=200,
                      policy=JPolicy(precision="highest",
                                     use_pallas=use_pallas is None))
    tobj = OTObjective(eps=eps, tol=0.0, max_iter=200,
                       policy=ExecutionPolicy(precision="highest",
                                              use_pallas=use_pallas))

    def jloss(*leaves):
        geom = (jobj.gaussian(*leaves, R=R) if kind == "gaussian"
                else jobj.factored(*leaves))
        return jobj.divergence(geom, _j(a), _j(b))

    jval, jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))))(*(_j(v) for v in args))
    leaves = [_t(v).requires_grad_(True) for v in args]
    geom = (tobj.gaussian(*leaves, R=R) if kind == "gaussian"
            else tobj.factored(*leaves))
    val = tobj.divergence(geom, _t(a), _t(b))
    grads = torch.autograd.grad(val, leaves)
    assert float(val) == pytest.approx(float(jval), rel=1e-5)
    for gt, gj in zip(grads, jgrads):
        assert torch.isfinite(gt).all()
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-7)


def test_objective_refuses_mesh_and_a_foreign_device(tmp_path):
    """A policy's mesh must have the axis (the JAX package's ValueError);
    one that has it runs the divergence sharded, here over a gloo world
    of this process alone, equal to the single-device divergence."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_sharded_worker as W
    bad = OTObjective(eps=0.5, policy=ExecutionPolicy(mesh=object()))
    cx, cy, cu, R = _clouds(3, 12, 10, 2, 6, 0.5)
    x, y, u = _t(cx), _t(cy), _t(cu)
    with pytest.raises(ValueError, match="no axis named"):
        bad.divergence(bad.gaussian(x, y, u, R=R))
    local = OTObjective(eps=0.5, tol=1e-6, max_iter=500)
    with W.world_of_one(tmp_path / "init") as mesh:
        obj = OTObjective(eps=0.5, tol=1e-6, max_iter=500,
                          policy=ExecutionPolicy(mesh=mesh, device="cpu"))
        assert "mesh={'data': 1}@data" in obj.policy.describe()
        got = obj.divergence(obj.gaussian(x, y, u, R=R))
    want = local.divergence(local.gaussian(x, y, u, R=R))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    obj = OTObjective(eps=0.5, policy=ExecutionPolicy(device="cuda"))
    geom = obj.gaussian(torch.zeros(3, 2), torch.ones(4, 2),
                        torch.zeros(5, 2), R=2.0)
    with pytest.raises((ValueError, RuntimeError)):
        obj.divergence(geom)
    with pytest.raises(ValueError, match="eps"):
        OTObjective(eps=0.4).divergence(geom)


# ---------------------------------------------------------------------------
# One OT-GAN trainer step against the JAX example
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_ot_gan_example", ROOT / "examples" / "ot_gan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_step(mod, params, z, data, obj, adv, lr_g=3e-3, lr_adv=1e-3):
    """The example's train_step body, from its own functions."""
    def loss_fn(p):
        fake = mod.mlp_apply(p["gen"], z)
        geom = obj.gaussian(mod.embed(p["emb"], fake),
                            mod.embed(p["emb"], data), p["anchors"],
                            R=mod.R_BALL)
        return obj.divergence(geom)

    d, grads = jax.value_and_grad(loss_fn)(params)
    sign = {"gen": -1.0, "emb": +1.0, "anchors": +1.0}
    new = {}
    for name in params:
        s = sign[name] * (lr_g if name == "gen" else lr_adv)
        if adv == (name == "gen"):
            new[name] = params[name]
        else:
            new[name] = jax.tree.map(lambda p_, g_: p_ + s * g_,
                                     params[name], grads[name])
    return d, new


def _flat_jax(params):
    """One flat array per layer (weight and bias) and one for the anchors."""
    out = []
    for name in ("gen", "emb"):
        for layer in params[name]:
            out.append(np.concatenate([np.asarray(layer["w"]).T.ravel(),
                                       np.asarray(layer["b"])]))
    return out + [np.asarray(params["anchors"]).ravel()]


def _flat_port(model):
    out = []
    for mlp in (model.gen, model.emb):
        for lin in mlp.layers:
            out.append(np.concatenate([lin.weight.detach().numpy().ravel(),
                                       lin.bias.detach().numpy()]))
    return out + [model.anchors.detach().numpy().ravel()]


@pytest.mark.parametrize("adv", [True, False])
def test_trainer_step_matches_jax_example(jax_example, adv):
    mod = jax_example
    batch, r, iters = 32, 16, 16
    key = jax.random.PRNGKey(0)
    kg, ke, ka = jax.random.split(key, 3)
    params = {
        "gen": mod.init_mlp_stack(kg, [mod.LATENT_Z, 128, 128, 2]),
        "emb": mod.init_mlp_stack(ke, [2, 64, mod.LATENT_D]),
        "anchors": JFeatureMap(r=r, d=mod.LATENT_D, eps=mod.EPS,
                               R=mod.R_BALL).init(ka),
    }
    rng = np.random.default_rng(11)
    z = rng.standard_normal((batch, mod.LATENT_Z)).astype(np.float32)
    data = (2.0 * rng.standard_normal((batch, 2)) / 2).astype(np.float32)
    jobj = JObjective(eps=mod.EPS, tol=0.0, max_iter=iters,
                      policy=JPolicy.training(use_pallas=True, inner_steps=8))
    tobj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=iters,
                       policy=ExecutionPolicy.training(use_pallas=True,
                                                       inner_steps=8))
    model = convert.gan_params(
        {k: jax.tree.map(np.asarray, v) for k, v in params.items()},
        device="cpu")
    jd, jnew = _jax_step(mod, params, _j(z), _j(data), jobj, adv)
    td, _ = ot_gan.train_step(model, _t(z), _t(data), tobj, adv=adv)
    # Wbar is a difference of three solves, so it carries their
    # bf16 rounding, amplified by the cancellation
    assert float(td) == pytest.approx(float(jd), rel=1e-3)
    for got, want in zip(_flat_port(model), _flat_jax(jnew)):
        scale = float(np.max(np.abs(want)))
        assert float(np.max(np.abs(got - want))) <= 1e-4 * scale


def test_objective_solve_matches_jax_and_waits_for_the_scaling_plan():
    """``OTObjective.solve`` on point clouds runs the fused scaling plan
    (it no longer waits for it) and the plain operators; both match the
    JAX objective's solve."""
    eps = 0.5
    x, y, u, R = _clouds(8, 30, 20, 2, 16, eps)
    jobj = JObjective(eps=eps, tol=0.0, max_iter=50,
                      policy=JPolicy(use_pallas=False))
    jgeom = jobj.gaussian(_j(x), _j(y), _j(u), R=R)
    want = jobj.solve(jgeom, *jobj.uniform_weights(jgeom))
    fused = OTObjective(eps=eps, tol=0.0, max_iter=50)
    geom = fused.gaussian(_t(x), _t(y), _t(u), R=R)
    with observe_plan_selection() as events:
        got_fused = fused.solve(geom, *fused.uniform_weights(geom))
    assert [e["mode"] for e in events] == ["scaling"]
    plain = OTObjective(eps=eps, tol=0.0, max_iter=50,
                        policy=ExecutionPolicy(use_pallas=False))
    got = plain.solve(geom, *plain.uniform_weights(geom))
    for res in (got, got_fused):
        assert res.n_iter == 50
        assert float(res.cost) == pytest.approx(float(want.cost), rel=1e-5)


def test_trainer_entry_point_strict_on_the_cpu():
    out = ot_gan.main(["--device", "cpu", "--strict", "--steps", "8",
                       "--batch", "32", "--r", "16", "--iters", "8"])
    assert len(out["divergences"]) == 8 and out["adv"] == [True] * 3 + [
        False] + [True] * 3 + [False]
    assert out["block_launches"] == [0] * 8   # plain versions launch nothing
